"""One stage-1 training step of the port against the JAX trainer at tiny
widths (`styletts2_tpu/parallel/tiny.py`, a 2-layer WavLM).

The same numpy-seeded weights go into both. The generator loss and the
gradients of every stepped module are compared with `jax.value_and_grad`
over the JAX trainer's own forward (`Stage1Trainer._forward_recon`) and
losses, before TMA (the unscaled mel loss; text encoder, style encoder,
decoder) and from TMA on (lambda-weighted mel, mono, s2s, WavLM and
adversarial terms; the aligner too), with the modules in eval mode, every
random draw zeroed and the harmonic source's chaotic STFT phase zeroed, as
tests/test_torch_decoder.py. Then one real TMA `train_step` of the port
shows its order: the discriminators step first, and the adversarial term is
taken against the updated ones; only the phase's modules move, the pitch
extractor by its weight decay alone, and the style encoder's spectral-norm
vectors advance.

Tolerances: 1e-4 relative for the losses (f32 reductions in another order
through ~40 layers). Gradients: the L2 norm of the difference over each
module's gradient, below 3e-2 of the JAX gradient's norm. A random-init
network's gradient is ill-conditioned in its deepest inputs: scaling the
port's own weights by 1 + 1e-7 * N(0, 1) moves its text encoder's gradient
by up to 1% of the peak, and the two frameworks' roundings differ by more
than that (measured here: 1.2e-2 for the text encoder, <= 6e-3 for every
other module). The soft attention with the adversarial term is worse still
(its median and masks select other elements), so the TMA case takes the
hard monotonic path, as the reference does half the time.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import styletts2_tpu_torch.convert as pc
from styletts2_tpu import losses as JL
from styletts2_tpu.models.build import _fi_spectral_align, build_training_models, init_training_params
from styletts2_tpu.models.wavlm import WavLM as JaxWavLM
from styletts2_tpu.models.wavlm import resample_24k_to_16k as jax_resample
from styletts2_tpu.parallel.tiny import tiny_config
from styletts2_tpu.train.stage1 import Stage1Trainer as JaxStage1
from styletts2_tpu.train.stage1 import s2s_ce_loss as jax_s2s_ce_loss
from styletts2_tpu_torch import losses as PL
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.models.wavlm import WavLM
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train.state import TrainState, build_optimizers
from torch_parity import _fill, port_cfg, rel_err, stable_har_phase, zero_noise

WAVLM = dict(hidden=32, heads=2, intermediate=48, num_layers=2)
KEYS = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor", "mpd",
        "msd", "wavlm")
B, WAV_LEN, CLIP = 2, 48000, 40
GRAD_TOL = 3e-2


def _stats(tree, rng):
    if "mean" in tree:
        return {"mean": (0.1 * rng.standard_normal(tree["mean"].shape)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(np.float32)}
    return {k: _stats(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config()
    models = dataclasses.replace(build_training_models(jcfg), wavlm=JaxWavLM(**WAVLM))
    shapes = jax.eval_shape(lambda k: init_training_params(models, k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    variables = {}
    for k in KEYS:
        v = {"params": _fill(shapes[k]["params"], rng)}
        if "batch_stats" in shapes[k]:
            v["batch_stats"] = _stats(shapes[k]["batch_stats"], rng)
        if "spectral" in shapes[k]:
            v["spectral"] = _fill(shapes[k]["spectral"], rng)
            _fi_spectral_align(v["spectral"], v["params"])
        variables[k] = v
    # keep the iSTFT head's exp inside f32's range (tests/torch_parity.py)
    variables["decoder"]["params"]["generator"]["conv_post"]["g"] *= 0.1
    pcfg = port_cfg(jcfg)
    port = pbuild.build_training_models(pcfg)
    port["wavlm"] = WavLM(**WAVLM)
    port.load_state_dict(state_dict_from_jax(variables, pcfg, keys=KEYS))

    waves = (0.2 * rng.standard_normal((B, WAV_LEN))).astype(np.float32)
    batch = {"waves": waves, "tokens": rng.integers(1, 178, (B, 12)).astype(np.int32),
             "input_lengths": np.asarray([12, 9], np.int32),
             "mel_lengths": np.asarray([160, 140], np.int32)}
    starts = np.asarray([3, 5], np.int32)
    return jcfg, models, variables, pcfg, port, batch, starts


def _jax_step(jcfg, models, variables, batch, starts, use_mono, tma):
    """value_and_grad of the JAX trainer's generator loss over the stepped
    modules, in eval mode."""
    lp = jcfg.loss_params
    keys = pstage1.GEN_KEYS + (("text_aligner",) if tma else ())
    variables = jax.tree.map(jnp.asarray, variables)
    params = {k: v["params"] for k, v in variables.items()}
    extras = {k: {c: x for c, x in v.items() if c != "params"} for k, v in variables.items()}
    ns = types.SimpleNamespace(models=models, mp=False, multispeaker=False)
    bd = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(gp, params, extras):  # everything an argument: no weights folded as constants
        p = dict(params, **gp)
        y, w, aux = JaxStage1._forward_recon(ns, p, extras, bd, jnp.asarray(starts),
                                             jnp.asarray(starts), jax.random.PRNGKey(0), CLIP,
                                             jnp.asarray(use_mono), train=False)
        mel = JL.multires_stft_loss(y, w)
        if not tma:
            return mel, {"mel": mel}
        s2s = jax_s2s_ce_loss(aux["s2s_pred"], bd["tokens"], bd["input_lengths"])
        mono = jnp.mean(jnp.abs(aux["s2s_attn"] - aux["mono"])) * 10.0
        wl = {"params": params["wavlm"]}
        real = [jax.lax.stop_gradient(h) for h in models.wavlm.apply(wl, jax_resample(w))]
        slm = JL.wavlm_feature_loss(real, models.wavlm.apply(wl, jax_resample(y)))
        gen = JL.generator_adv_loss(models.mpd.apply({"params": params["mpd"]}, w, y),
                                    models.msd.apply({"params": params["msd"]}, w, y))
        total = (lp.lambda_mel * mel + lp.lambda_mono * mono + lp.lambda_s2s * s2s
                 + lp.lambda_slm * slm + lp.lambda_gen * gen)
        return total, {"mel": mel, "s2s": s2s, "mono": mono, "slm": slm, "gen": gen}

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: params[k] for k in keys}, params, extras)
    return total, metrics, grads, extras


def _port_grads(port, key):
    """The module's gradients, zeros where none arrived (the NSF source's
    linear layer, behind a stop-gradient in both packages); the LSTMs'
    bias_hh is left out (the JAX LSTMs have one bias: bias_ih's gradient)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in port[key].named_parameters() if "bias_hh" not in n}


def _jax_grads_as_port(key, grads, extras):
    sd = {}
    pc._MODULES[key](dict(extras[key], params=grads[key]), sd)
    return sd


@pytest.mark.parametrize("use_mono,tma", [(0, False), (1, True)])
def test_generator_loss_and_grads_match_jax(setup, use_mono, tma):
    jcfg, models, variables, pcfg, port, batch, starts = setup
    with zero_noise(), stable_har_phase():
        total, metrics, grads, extras = _jax_step(jcfg, models, variables, batch, starts,
                                                  use_mono, tma)
        keys = pstage1.GEN_KEYS + (("text_aligner",) if tma else ())
        for k, mod in port.items():
            mod.eval().requires_grad_(k in keys)
            mod.zero_grad(set_to_none=True)
        trainer = pstage1.Stage1Trainer(pcfg, TrainState(port, {}), "cpu")
        tensors = trainer._tensors(types.SimpleNamespace(**batch))
        y, w, aux = trainer.forward_recon(*tensors, starts, starts, CLIP, bool(use_mono))
        g_loss, got = trainer.generator_losses(y, w, aux, tensors[1], tensors[2], tma)
        if tma:
            got["gen"] = PL.generator_adv_loss(port["mpd"](w, y), port["msd"](w, y))
            g_loss = g_loss + pcfg.loss_params.lambda_gen * got["gen"]
        g_loss.backward()
    assert sorted(got) == sorted(metrics)
    for name, v in metrics.items():
        assert abs(float(got[name].detach()) - float(v)) <= 1e-4 * abs(float(v)), name
    assert abs(float(g_loss.detach()) - float(total)) <= 1e-4 * abs(float(total))
    for key in keys:
        want = _jax_grads_as_port(key, grads, extras)
        have = _port_grads(port, key)
        assert set(have) <= set(want), key
        got_flat = np.concatenate([have[n].numpy().ravel() for n in sorted(have)])
        want_flat = np.concatenate([np.asarray(want[n]).ravel() for n in sorted(have)])
        norm = np.linalg.norm(want_flat)
        assert norm > 0, key
        assert np.linalg.norm(got_flat - want_flat) < GRAD_TOL * norm, key
    for key in set(port) - set(keys):  # nothing else gets a gradient
        assert all(p.grad is None for p in port[key].parameters()), key


def _batch(batch):
    n = batch["waves"].shape[0]
    zeros = np.zeros(n, np.int32)
    return Batch(waves=batch["waves"], wave_lengths=np.full(n, WAV_LEN), tokens=batch["tokens"],
                 input_lengths=batch["input_lengths"], ref_tokens=batch["tokens"],
                 ref_lengths=batch["input_lengths"], mel_lengths=batch["mel_lengths"],
                 ref_waves=batch["waves"], ref_wave_lengths=np.full(n, WAV_LEN), speakers=zeros)


def test_tma_step_updates_discriminators_before_the_adversarial_term(setup):
    _, _, _, pcfg, port, batch, _ = setup
    port = copy.deepcopy(port)
    cfg = copy.deepcopy(pcfg)
    cfg.optimizer_params.lr = 1e-2  # the pitch extractor's decay (lr * 1e-4) shows in f32
    state = TrainState(port, build_optimizers(cfg, port))
    trainer = pstage1.Stage1Trainer(cfg, state, "cpu")
    seen = {}
    forward = trainer.forward_recon

    def spy(*a, **k):
        seen["y"], seen["w"], _ = out = forward(*a, **k)
        return out

    trainer.forward_recon = spy
    before = {k: {n: p.detach().clone() for n, p in m.state_dict().items()} for k, m in port.items()}
    torch.manual_seed(0)
    metrics = trainer.train_step(_batch(batch), epoch=cfg.loss_params.TMA_epoch, iters=0,
                                 rng=np.random.default_rng(0))
    assert state.step == 1 and all(np.isfinite(v) for v in metrics.values())
    assert {"d_loss", "gen", "s2s", "mono", "slm", "mel", "g_loss"} <= set(metrics)
    y, w = seen["y"].detach(), seen["w"]
    with torch.no_grad():
        now = float(PL.generator_adv_loss(port["mpd"](w, y), port["msd"](w, y)))
        old = {k: copy.deepcopy(port[k]).requires_grad_(False) for k in ("mpd", "msd")}
        for k in old:
            old[k].load_state_dict(before[k])
        stale = float(PL.generator_adv_loss(old["mpd"](w, y), old["msd"](w, y)))
    assert metrics["gen"] == pytest.approx(now, rel=1e-6)  # the updated discriminators
    assert abs(stale - now) > 1e-4 * abs(now)
    lr_decay = 1.0 - cfg.optimizer_params.lr * 1e-4
    for k, m in port.items():
        moved = [n for n, p in m.named_parameters() if not torch.equal(p, before[k][n])]
        if k == "wavlm":
            assert not moved  # frozen
        elif k == "pitch_extractor":  # no gradient: the weight decay alone
            for n, p in m.named_parameters():
                torch.testing.assert_close(p, before[k][n] * lr_decay, rtol=1e-6, atol=0)
        else:
            assert moved, k
    u = port["style_encoder"].shared[0].weight_u
    assert not torch.equal(u, before["style_encoder"]["shared.0.weight_u"])  # one power iteration
