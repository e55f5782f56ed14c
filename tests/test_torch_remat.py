"""`remat_decoder`: activation checkpointing of the decoder's Generator
(`models/decoder_istft.py:rematerialized`) on the CPU at tiny widths
(tests/torch_tiny_train.py).

- A decoder run with remat gives the same waveform and the same gradients
  as without, for both Generators, while its NSF source draws non-zero
  sines and noise from an explicit `torch.Generator`: the source is drawn
  before the checkpoint and handed to the body, so the backward's
  recompute reads the same draws. Drawn inside the checkpoint, the
  recompute would advance the generator and differentiate another forward
  (the gradients then differ by O(1) of their norm).
- A stage-1 TMA `train_step` and a stage-2 joint `train_step` with remat
  equal the same steps without it: every logged loss and every stepped
  module's gradient at each optimizer step, within 1e-6 relative (measured
  here: 0, the recompute repeats the forward's ops), in f32 and in bf16
  (`mixed_precision: bf16`, where the recompute must read the step's bf16
  copies of the weights, not the f32 masters).
- The port's stage-1 generator loss and gradients with remat match the JAX
  trainer's with `remat_decoder=True` (tests/test_torch_stage1.py's case
  before TMA, its tolerances).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from styletts2_tpu.models.build import build_training_models as jax_build_training_models
from styletts2_tpu.parallel.tiny import tiny_config
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train import stage2 as pstage2
from styletts2_tpu_torch.train.state import TrainState
from test_torch_stage1 import setup as stage1_setup  # noqa: F401 (a fixture)
from torch_parity import stable_har_phase, zero_noise
from torch_tiny_train import run_step, tiny_batch, tiny_cfg, tiny_models

REL = 1e-6


def assert_same_step(got, want, rel=REL):
    m_got, g_got, _ = got
    m_want, g_want, _ = want
    assert sorted(m_got) == sorted(m_want)
    for k, v in m_want.items():
        assert abs(m_got[k] - v) <= rel * max(abs(v), 1e-12), (k, m_got[k], v)
    assert [sorted(s) for s in g_got] == [sorted(s) for s in g_want]
    for a, b in zip(g_got, g_want):
        for k in b:
            norm = float(b[k].norm())
            assert float((a[k] - b[k]).norm()) <= rel * max(norm, 1e-30), k


@pytest.mark.parametrize("decoder", ["istftnet", "hifigan"])
def test_remat_replays_the_generators_draws(decoder):
    cfg = tiny_cfg()
    if decoder == "hifigan":
        cfg.model_params.decoder.type = "hifigan"
        cfg.model_params.decoder.upsample_rates = [10, 5, 3, 2]
        cfg.model_params.decoder.upsample_kernel_sizes = [20, 10, 6, 4]
    rng = np.random.default_rng(1)
    B, T = 2, 20
    asr = torch.from_numpy(rng.standard_normal((B, cfg.model_params.hidden_dim, T)).astype(np.float32))
    f0 = torch.from_numpy(rng.uniform(100.0, 220.0, (B, 2 * T)).astype(np.float32))
    n = torch.from_numpy(rng.standard_normal((B, 2 * T)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((B, cfg.model_params.style_dim)).astype(np.float32))
    runs = []
    for remat in (False, True):
        dec = pbuild._decoder(dataclasses.replace(cfg, remat_decoder=remat))
        pbuild._init_weights(dec, torch.Generator().manual_seed(0))
        dec.generator.conv_post.weight_g.data.mul_(0.1)  # the head out of exp's overflow
        dec.train()
        sines = []
        hook = dec.generator.m_source.l_sin_gen.register_forward_hook(
            lambda mod, a, out: sines.append(out[0].detach()))
        x = asr.clone().requires_grad_(True)
        wav = dec(x, f0, n, s, torch.Generator().manual_seed(7))
        hook.remove()
        weight = torch.from_numpy(np.random.default_rng(2).standard_normal(wav.shape).astype(np.float32))
        (wav * weight).sum().backward()
        grads = torch.cat([x.grad.flatten()] + [p.grad.flatten() for p in dec.parameters()
                                                  if p.grad is not None])
        runs.append((wav.detach(), grads, sines))
    (w0, g0, s0), (w1, g1, s1) = runs
    assert len(s0) == 1 and len(s1) == 1  # the source is drawn once, before the checkpoint
    voiced = s0[0] * 1.0
    assert float(voiced.abs().max()) > 0.05  # voiced sines, not only the noise
    torch.testing.assert_close(s1[0], s0[0], rtol=0, atol=0)
    torch.testing.assert_close(w1, w0, rtol=0, atol=0)
    assert float((g1 - g0).norm()) <= REL * float(g0.norm())


@pytest.mark.parametrize("precision", ["", "bf16"])
def test_stage1_tma_step_equals_without_remat(precision):
    cfg, batch = tiny_cfg(mixed_precision=precision), tiny_batch(2)
    remat = dataclasses.replace(cfg, remat_decoder=True)
    tma = cfg.loss_params.TMA_epoch
    want = run_step(pstage1.Stage1Trainer, cfg, tiny_models(cfg), batch, tma)
    models = tiny_models(remat)  # the same weights, the Generator checkpointed
    assert models["decoder"].generator.remat
    got = run_step(pstage1.Stage1Trainer, remat, models, batch, tma)
    assert {"d_loss", "gen", "slm", "mel"} <= set(want[0])
    assert_same_step(got, want)


@pytest.mark.parametrize("precision", ["", "bf16"])
def test_stage2_joint_step_equals_without_remat(precision):
    cfg, batch = tiny_cfg(mixed_precision=precision), tiny_batch(2)
    cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch, cfg.slmadv_params.iter = 0, 0, 1
    remat = dataclasses.replace(cfg, remat_decoder=True)
    want = run_step(pstage2.Stage2Trainer, cfg, tiny_models(cfg, "second"), batch, 0)
    models = tiny_models(remat, "second")
    assert models["decoder"].generator.remat
    got = run_step(pstage2.Stage2Trainer, remat, models, batch, 0)
    assert {"slm_gen", "slm_d", "d_loss"} <= set(want[0])
    assert len(want[1]) == 4  # D, G, the SLM pass, wd
    assert_same_step(got, want)


def test_remat_stage1_matches_jax_remat(stage1_setup):  # noqa: F811
    """tests/test_torch_stage1.py's generator loss and gradients before TMA,
    both sides rematerializing their Generators."""
    import test_torch_stage1 as s1

    jcfg = dataclasses.replace(tiny_config(), remat_decoder=True)
    _, models, variables, pcfg, port, batch, starts = stage1_setup
    models = dataclasses.replace(models, decoder=jax_build_training_models(jcfg).decoder)
    assert models.decoder.remat
    pcfg = dataclasses.replace(pcfg, remat_decoder=True)
    remat_port = pbuild.build_training_models(pcfg)
    remat_port["wavlm"] = port["wavlm"]
    remat_port.load_state_dict(port.state_dict())
    assert remat_port["decoder"].generator.remat
    with zero_noise(), stable_har_phase():
        total, metrics, grads, extras = s1._jax_step(jcfg, models, variables, batch, starts, 0, False)
        for k, mod in remat_port.items():
            mod.eval().requires_grad_(k in pstage1.GEN_KEYS)
            mod.zero_grad(set_to_none=True)
        trainer = pstage1.Stage1Trainer(pcfg, TrainState(remat_port, {}), "cpu")
        tensors = trainer._tensors(types.SimpleNamespace(**batch))
        y, w, aux = trainer.forward_recon(*tensors, starts, starts, s1.CLIP, False)
        g_loss, got = trainer.generator_losses(y, w, aux, tensors[1], tensors[2], False)
        g_loss.backward()
    assert abs(float(got["mel"].detach()) - float(metrics["mel"])) <= 1e-4 * abs(float(metrics["mel"]))
    for key in pstage1.GEN_KEYS:
        want = s1._jax_grads_as_port(key, grads, extras)
        have = s1._port_grads(remat_port, key)
        got_flat = np.concatenate([have[n].numpy().ravel() for n in sorted(have)])
        want_flat = np.concatenate([np.asarray(want[n]).ravel() for n in sorted(have)])
        norm = np.linalg.norm(want_flat)
        assert norm > 0 and np.linalg.norm(got_flat - want_flat) < s1.GRAD_TOL * norm, key
