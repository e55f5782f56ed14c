"""The stage-1 trainer's modules of the port against the JAX package at tiny
widths: the ASR aligner (eval mode), the JDC pitch extractor, the MPD / MRSD
discriminators, WavLM (2 layers, narrow), the 24 -> 16 kHz resampler, the
monotonic alignment, and the bit-exact `state_dict_from_jax` round trip
through the JAX package's converters.

Tolerance: 1e-4 of the output's peak for the convolutional and recurrent
stacks (the same f32 arithmetic in another summation order through up to
~30 layers); the DP paths and the converters must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu import convert as jconvert
from styletts2_tpu.models import asr as jasr
from styletts2_tpu.models import discriminators as jdisc
from styletts2_tpu.models import jdc as jjdc
from styletts2_tpu.models import wavlm as jwavlm
from styletts2_tpu.ops.align import maximum_path as jax_maximum_path
from styletts2_tpu_torch import convert as pconvert
from styletts2_tpu_torch.models import asr as pasr
from styletts2_tpu_torch.models import discriminators as pdisc
from styletts2_tpu_torch.models import jdc as pjdc
from styletts2_tpu_torch.models import wavlm as pwavlm
from styletts2_tpu_torch.ops.align import maximum_path, maximum_path_ref

from torch_parity import _fill, rel_err, t

TOL = 1e-4


def _variables(module, rng, *args):
    """Random variables of a JAX module with numpy-seeded leaves; BatchNorm
    statistics get a positive variance."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0))
    v = {"params": _fill(shapes["params"], rng)}
    if "batch_stats" in shapes:
        v["batch_stats"] = _stats(shapes["batch_stats"], rng)
    return v


def _stats(tree, rng):
    if "mean" in tree:
        return {"mean": (0.1 * rng.standard_normal(tree["mean"].shape)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
    return {k: _stats(v, rng) for k, v in tree.items()}


def _port(module, key, variables):
    sd = {}
    fn = pconvert._MODULES[key]
    fn(variables, sd)
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return module.requires_grad_(False).eval()


def test_asr_aligner_eval(rng):
    B, T_mel, T_text = 2, 24, 7
    jm = jasr.ASRCNN(hidden_dim=32, n_layers=2, token_embedding_dim=16)
    mel = rng.standard_normal((B, 80, T_mel)).astype(np.float32)
    valid = np.ones((B, T_mel // 2), np.float32)
    valid[1, 9:] = 0
    tokens = rng.integers(1, 178, (B, T_text)).astype(np.int32)
    v = _variables(jm, rng, mel, valid, tokens)
    want = jax.jit(lambda v: jm.apply(v, mel, valid, tokens))(v)
    pm = _port(pasr.ASRCNN(hidden_dim=32, n_layers=2, token_embedding_dim=16), "text_aligner", v)
    got = pm(t(mel), t(valid), torch.from_numpy(tokens).long())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g, w) < TOL
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-5)  # attention rows
    assert float(got[2][1, :, 9:].abs().max()) == 0.0  # masked memory


def test_jdc_pitch_extractor(rng):
    B, T = 2, 16
    jm = jjdc.JDCNet(num_class=1)
    mel = rng.standard_normal((B, 80, T)).astype(np.float32)
    v = _variables(jm, rng, mel)
    f0, gan, pool = jax.jit(lambda v: jm.apply(v, mel))(v)
    pm = _port(pjdc.JDCNet(1), "pitch_extractor", v)
    pm.train()  # BatchNorm keeps its running statistics in either mode
    g_f0, g_gan, g_pool = pm(t(mel))
    assert rel_err(g_f0, f0) < TOL
    assert rel_err(g_gan.permute(0, 2, 3, 1), gan) < TOL
    assert rel_err(g_pool, pool) < TOL


@pytest.mark.parametrize("kind", ["mpd", "msd"])
def test_discriminators(rng, kind):
    B, T = 2, 2403  # not a multiple of any period
    jm = jdisc.MultiPeriodDiscriminator() if kind == "mpd" else jdisc.MultiResSpecDiscriminator()
    pm = pdisc.MultiPeriodDiscriminator() if kind == "mpd" else pdisc.MultiResSpecDiscriminator()
    y = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    v = _variables(jm, rng, y, y_hat)
    want = jax.jit(lambda v: jm.apply(v, y, y_hat))(v)
    got = _port(pm, kind, v)(t(y), t(y_hat))
    for gl, wl in zip(got[:2], want[:2]):  # logits per discriminator
        for g, w in zip(gl, wl):
            assert rel_err(g, w) < TOL
    for gf, wf in zip(got[2] + got[3], want[2] + want[3]):  # feature maps, NCHW vs NHWC
        for g, w in zip(gf, wf):
            assert rel_err(g.permute(0, 2, 3, 1), w) < TOL


def test_wavlm_two_layers(rng):
    kw = dict(hidden=32, heads=2, intermediate=48, num_layers=2)
    jm = jwavlm.WavLM(**kw)
    wav = (0.3 * rng.standard_normal((2, 3200))).astype(np.float32)
    v = _variables(jm, rng, wav)
    want = jax.jit(lambda v: jm.apply(v, wav))(v)
    got = _port(pwavlm.WavLM(**kw), "wavlm", v)(t(wav))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g, w) < TOL


def test_resample_24k_to_16k(rng):
    wav = rng.standard_normal((2, 4801)).astype(np.float32)
    want = np.asarray(jwavlm.resample_24k_to_16k(jnp.asarray(wav)))
    got = pwavlm.resample_24k_to_16k(t(wav)).numpy()
    assert got.shape == want.shape == (2, 3201)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_maximum_path(seed):
    """Lengths shorter than the padding, ties broken the same way."""
    rng = np.random.default_rng(seed)
    B, T_text, T_mel = 3, 11, 29
    scores = rng.standard_normal((B, T_text, T_mel)).astype(np.float32)
    scores[2, :, :5] = 0.5  # ties
    tls, mls = np.asarray([11, 7, 4]), np.asarray([29, 20, 9])
    want = np.asarray(jax_maximum_path(jnp.asarray(scores), jnp.asarray(tls), jnp.asarray(mls)))
    np.testing.assert_array_equal(maximum_path(t(scores), tls, mls).numpy(), want)
    np.testing.assert_array_equal(maximum_path_ref(t(scores), tls, mls).numpy(), want)


def _hf_pos_conv(sd):
    """The port's folded positional conv as the Hugging Face weight-norm
    pair `convert_wavlm` reads: v = w, g = ||w|| over (out, in/g) per tap."""
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    sd["encoder.pos_conv_embed.conv.weight_g"] = np.sqrt((w.astype(np.float64) ** 2).sum(
        axis=(0, 1), keepdims=True)).astype(np.float32)
    return sd


def test_state_dict_round_trip_is_exact(rng):
    """JAX variables -> port state_dict -> the JAX package's converter gives
    the variables back bit for bit; WavLM's positional conv passes through a
    weight-norm fold on the way back and is held to 2 ulp."""
    wav = np.zeros((1, 2400), np.float32)
    cases = {
        "text_aligner": (jasr.ASRCNN(hidden_dim=32, token_embedding_dim=16),  # 6 layers, as read
                         (np.zeros((1, 80, 16), np.float32), np.ones((1, 8), np.float32),
                          np.zeros((1, 5), np.int32)), jconvert.convert_asr),
        "pitch_extractor": (jjdc.JDCNet(), (np.zeros((1, 80, 8), np.float32),), jconvert.convert_jdc),
        "mpd": (jdisc.MultiPeriodDiscriminator(), (wav, wav), jconvert.convert_mpd),
        "msd": (jdisc.MultiResSpecDiscriminator(), (wav, wav), jconvert.convert_msd),
        "wavlm": (jwavlm.WavLM(hidden=32, heads=2, intermediate=48, num_layers=3),
                  (np.zeros((1, 3200), np.float32),),
                  lambda sd: jconvert.convert_wavlm(_hf_pos_conv(sd), num_layers=3)),
    }
    for key, (jm, args, back) in cases.items():
        v = _variables(jm, rng, *args)
        sd = {}
        pconvert._MODULES[key](v, sd)
        again = back({k: np.asarray(x) for k, x in sd.items()})
        want = jax.tree_util.tree_leaves_with_path(v)
        got = dict(jax.tree_util.tree_leaves_with_path(again))
        assert set(got) == {p for p, _ in want}, key
        for path, leaf in want:
            a, b = np.asarray(got[path]), np.asarray(leaf)
            if key == "wavlm" and "pos_conv" in jax.tree_util.keystr(path) and b.ndim == 3:
                np.testing.assert_allclose(a, b, rtol=2.4e-7, atol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{key} {jax.tree_util.keystr(path)}")
