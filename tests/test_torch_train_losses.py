"""The stage-1 trainer's losses, its train-mode layers and its optimizer in
the port against the JAX package on the CPU: every loss of
`styletts2_tpu/losses.py` that stage 1 uses and `s2s_ce_loss`, the loss mel
and `log_norm`, the spectral-norm Conv2d's power iteration
(`update_stats=True`), the decoder's random F0 / N box smoothing with the
choice injected, and one AdamW step per module against `optax.adamw`,
including a module that got no gradient and is only decayed.

Tolerances: 1e-6 relative for the scalar losses (the same f32 reductions
in another order); 1e-4 of the peak for the mel losses and mels, whose log
turns the FFTs' ~1e-7 relative error in the quietest bins into an absolute
one; 1e-5 of the peak for one SN convolution and its gradient; 1e-3 of the
peak for the whole decoder, as tests/test_torch_decoder.py; for the
optimizer 1e-6 relative and 2e-7 absolute, a few f32 ulps of O(0.3) weights
(a handful of f32 operations per element, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import styletts2_tpu_torch.convert as pc
import styletts2_tpu_torch.models.decoder_istft as pdi
from styletts2_tpu import losses as JL
from styletts2_tpu.models import decoder_istft as jdi
from styletts2_tpu.models import layers as jl
from styletts2_tpu.ops import stft as js
from styletts2_tpu.train.stage1 import s2s_ce_loss as jax_s2s_ce_loss
from styletts2_tpu_torch import losses as PL
from styletts2_tpu_torch.models import layers as pl
from styletts2_tpu_torch.ops import stft as ps
from styletts2_tpu_torch.train.state import build_optimizers, step_modules
from torch_parity import (_fill, jax_cfg, jax_models_and_params, port_cfg, port_models, rel_err,
                          stable_har_phase, t, zero_noise)


def _close(got, want, tol=1e-6):
    assert rel_err(got.detach().numpy(), np.asarray(want)) < tol


def _wave(rng, B, n):
    k = np.arange(n)
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * k / 24000)
            + 0.05 * rng.standard_normal((B, n))).astype(np.float32)


def test_multires_stft_loss(rng):
    x, y = _wave(rng, 2, 4801), _wave(rng, 2, 4801)
    _close(PL.multires_stft_loss(t(x), t(y)), JL.multires_stft_loss(jnp.asarray(x), jnp.asarray(y)),
           1e-4)


def test_loss_mel_and_log_norm(rng):
    """The losses' mel at the 24 kHz filterbank and one resolution, and the
    energy curve of a normalised log mel."""
    x = _wave(rng, 2, 6000)
    want = js.melspectrogram(jnp.asarray(x), n_fft=512, win_length=240, hop_length=50,
                             n_mels=80, fb_sample_rate=24000)
    got = ps.melspectrogram(t(x), n_fft=512, win_length=240, hop_length=50, fb_sample_rate=24000)
    assert got.shape == want.shape == (2, 80, 1 + 6000 // 50)
    assert rel_err(got, want) < 1e-4
    mel = np.asarray(js.preprocess_mel(jnp.asarray(x)))
    assert rel_err(ps.log_norm(t(mel)), js.log_norm(jnp.asarray(mel))) < 1e-5


def _disc_outputs(rng, B=2):
    """(real, gen, fmap_r, fmap_g) as a discriminator returns them: logits
    per sub-discriminator (sizes odd and even, for the median) and their
    feature maps."""
    sizes = [(B, 7), (B, 12), (B, 30)]
    real = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    gen = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    fshapes = [[(B, 5, 4), (B, 3, 2)], [(B, 6, 3)], [(B, 4, 4), (B, 2, 2), (B, 1, 1)]]
    fr = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in fshapes]
    fg = [[rng.standard_normal(s).astype(np.float32) for s in d] for d in fshapes]
    return real, gen, fr, fg


def _tree(fn, tree):
    return [_tree(fn, v) for v in tree] if isinstance(tree, (list, tuple)) else fn(tree)


def test_adversarial_losses(rng):
    mpd, msd = _disc_outputs(rng), _disc_outputs(rng)
    pm, pmsd = _tree(t, mpd), _tree(t, msd)
    jm, jmsd = _tree(jnp.asarray, mpd), _tree(jnp.asarray, msd)
    real, gen, fr, fg = mpd
    _close(PL.feature_loss(pm[2], pm[3]), JL.feature_loss(jm[2], jm[3]))
    _close(PL.lsgan_d_loss(pm[0], pm[1]), JL.lsgan_d_loss(jm[0], jm[1]))
    _close(PL.lsgan_g_loss(pm[1]), JL.lsgan_g_loss(jm[1]))
    # argument order matters (diff = first - second), and an even size takes
    # the lower median; a wide tau keeps the relu from hiding either
    for a, b in ((0, 1), (1, 0)):
        for tau in (0.04, 100.0):
            _close(PL.tprls_loss(pm[a], pm[b], tau), JL.tprls_loss(jm[a], jm[b], tau))
    assert float(PL.tprls_loss(pm[0], pm[1], 100.0)) != float(PL.tprls_loss(pm[1], pm[0], 100.0))
    _close(PL.generator_adv_loss(pm, pmsd), JL.generator_adv_loss(jm, jmsd))
    _close(PL.discriminator_adv_loss(pm, pmsd), JL.discriminator_adv_loss(jm, jmsd))


def test_lower_median(rng):
    diff = rng.standard_normal(10).astype(np.float32)
    assert float(torch.median(t(diff))) == float(JL._lower_median(jnp.asarray(diff)))


def test_wavlm_feature_loss(rng):
    real = [rng.standard_normal((2, 9, 16)).astype(np.float32) for _ in range(3)]
    rec = [rng.standard_normal((2, 9, 16)).astype(np.float32) for _ in range(3)]
    rec_t = [t(r).requires_grad_(True) for r in rec]
    real_t = [t(r).requires_grad_(True) for r in real]
    loss = PL.wavlm_feature_loss(real_t, rec_t)
    _close(loss, JL.wavlm_feature_loss([jnp.asarray(r) for r in real], [jnp.asarray(r) for r in rec]))
    loss.backward()
    assert all(r.grad is None for r in real_t)  # the real states carry no gradient
    assert all(r.grad is not None for r in rec_t)


def test_s2s_ce_loss(rng):
    B, T, V = 3, 7, 178
    logits = rng.standard_normal((B, T + 1, V)).astype(np.float32)
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    lengths = np.asarray([7, 4, 1], np.int32)
    want = jax_s2s_ce_loss(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(lengths))
    got = PL.s2s_ce_loss(t(logits), torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long())
    _close(got, want)


# the style encoder's stem, depthwise downsample and bias-free shortcut
@pytest.mark.parametrize("cin,cout,k,stride,pad,groups,bias", [
    (1, 8, 3, 1, 1, 1, True),
    (6, 6, 3, 2, 1, 6, True),
    (6, 12, 1, 1, 0, 1, False),
])
def test_snconv2d_power_iteration(rng, cin, cout, k, stride, pad, groups, bias):
    """An update_stats=True call runs one power iteration in f32, divides by
    the new sigma, whose gradient reaches the kernel through W, and stores
    the new (u, v) without gradient on commit_spectral_updates (JAX
    `update_stats=True`)."""
    x = rng.standard_normal((2, 11, 13, cin)).astype(np.float32)
    mod = jl.SNConv2d(cout, (k, k), stride=(stride, stride), padding=(pad, pad), groups=groups,
                      use_bias=bias)
    shapes = jax.eval_shape(lambda key: mod.init(key, x), jax.random.PRNGKey(0))
    variables = {c: _fill(v, rng) for c, v in shapes.items()}
    dy = rng.standard_normal(np.asarray(jax.eval_shape(
        lambda v: mod.apply(v, x), variables).shape)).astype(np.float32)

    def loss(params):
        y, mut = mod.apply({"params": params, "spectral": variables["spectral"]}, x,
                           update_stats=True, mutable=["spectral"])
        return jnp.sum(y * dy), (y, mut["spectral"])

    (_, (want, spectral)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    sd = {}
    pc._snconv2d(variables["params"], variables["spectral"], sd, "m")
    port = pl.SNConv2d(cin, cout, k, stride, pad, groups, bias).train()
    port.load_state_dict({n[2:]: t(v) for n, v in sd.items()})
    got = port(t(x.transpose(0, 3, 1, 2)), update_stats=True)
    assert rel_err(got.detach().numpy().transpose(0, 2, 3, 1), want) < 1e-5
    pl.commit_spectral_updates(port)
    after = {}
    pc._snconv2d(grads, spectral, after, "m")  # the converter maps grads like params
    for name in ("weight_u", "weight_v"):
        assert not getattr(port, name).requires_grad
        assert rel_err(getattr(port, name), after[f"m.{name}"]) < 1e-5, name
    (got * t(dy.transpose(0, 3, 1, 2))).sum().backward()
    assert rel_err(port.weight_orig.grad, after["m.weight_orig"]) < 1e-5
    port.eval()  # a call without update_stats keeps the stored vectors
    u = port.weight_u.clone()
    port(t(x.transpose(0, 3, 1, 2)))
    pl.commit_spectral_updates(port)
    assert torch.equal(port.weight_u, u)


def test_box_smooth_widths(rng):
    x = rng.standard_normal((2, 21)).astype(np.float32)
    for k in (3, 7, 15):
        assert rel_err(pdi.box_smooth(t(x), k), jdi._box_smooth(jnp.asarray(x), k)) < 1e-6


@pytest.mark.parametrize("f0_idx,n_idx", [(2, 3), (1, 0)])
def test_decoder_train_smoothing(f0_idx, n_idx, monkeypatch):
    """The train-mode Decoder with its two smoothing choices injected on
    both sides (indices into (0, 3, 7) and (0, 3, 7, 15)), other draws
    zeroed."""
    jcfg = jax_cfg()
    models, params = jax_models_and_params(jcfg, seed=6)
    port = port_models(jcfg, params)["decoder"].train()
    rng = np.random.default_rng(7)
    B, F = 2, 6
    H, S = jcfg.model_params.hidden_dim, jcfg.model_params.style_dim
    asr = rng.standard_normal((B, F, H)).astype(np.float32)
    f0 = rng.uniform(80.0, 260.0, (B, 2 * F)).astype(np.float32)
    n = rng.standard_normal((B, 2 * F)).astype(np.float32)
    s = rng.standard_normal((B, S)).astype(np.float32)
    picks = [f0_idx, n_idx]
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.asarray(picks[0 if hi == 3 else 1]))
    seen = []

    def port_randint(lo, hi, size, generator=None, device=None):
        seen.append(hi)
        return torch.tensor(picks[0 if hi == 3 else 1])

    monkeypatch.setattr(torch, "randint", port_randint)
    with zero_noise(), stable_har_phase():
        want = np.asarray(jax.jit(lambda v, *a: models.decoder.apply(
            v, *a, train=True, rngs={"noise": jax.random.PRNGKey(0)}))(params["decoder"], asr, f0, n, s))
        with torch.no_grad():
            got = port(t(asr.transpose(0, 2, 1)), t(f0), t(n), t(s)).numpy()
    assert seen == [3, 4]  # one draw each for F0 and N, from their own width lists
    assert rel_err(got, want) < 1e-3


def test_adamw_matches_optax(rng):
    """Three steps of the per-module AdamW (betas (0, 0.99), eps 1e-9, decay
    1e-4) against optax.adamw; the second module never gets a gradient, as
    the pitch extractor after TMA, and is stepped on its decay alone."""
    from styletts2_tpu_torch.config import Config

    cfg = Config()
    cfg.optimizer_params.lr = 0.05  # lr * decay above f32's resolution
    models = torch.nn.ModuleDict({"a": torch.nn.Linear(5, 4), "b": torch.nn.Linear(3, 2)})
    init = {k: {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
            for k, m in models.items()}
    opts = build_optimizers(cfg, models)
    tx = optax.adamw(cfg.optimizer_params.lr, b1=0.0, b2=0.99, eps=1e-9, weight_decay=1e-4)
    jparams = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in init.items()}
    jstate = {k: tx.init(v) for k, v in jparams.items()}
    for _ in range(3):
        x = rng.standard_normal((6, 5)).astype(np.float32)
        models["a"](t(x)).square().sum().backward()
        grads = {"a": {n: jnp.asarray(p.grad.numpy()) for n, p in models["a"].named_parameters()},
                 "b": jax.tree.map(jnp.zeros_like, jparams["b"])}
        step_modules(models, opts, ("a", "b"))
        for k in ("a", "b"):
            upd, jstate[k] = tx.update(grads[k], jstate[k], jparams[k])
            jparams[k] = optax.apply_updates(jparams[k], upd)
    for k, m in models.items():
        for n, p in m.named_parameters():
            assert p.grad is None  # cleared after the step
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k][n]), rtol=1e-6,
                                       atol=2e-7)
    b = models["b"].weight.detach().numpy()
    assert not np.array_equal(b, init["b"]["weight"])  # decayed, not skipped
    np.testing.assert_allclose(b, init["b"]["weight"] * (1 - 0.05 * 1e-4) ** 3, rtol=1e-6)
