"""Tiny training steps of the port for tests/test_torch_remat.py and
tests/test_torch_ddp.py, without JAX (the data-parallel test's spawned
ranks import this alone): `styletts2_tpu/parallel/tiny.py`'s widths, a
2-layer WavLM and discriminators of one period and one resolution (their
size does not change a step's structure, and the full ones take most of
its CPU time), seeded batches of unequal lengths, and `run_step`, one
`train_step` recording every optimizer step's gradients.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                       MultiResSpecDiscriminator)
from styletts2_tpu_torch.models.wavlm import WavLM
from styletts2_tpu_torch.parallel.tiny import tiny_config
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train import stage2 as pstage2
from styletts2_tpu_torch.train.state import TrainState, build_optimizers

torch.set_num_threads(1)  # one thread per test worker, as tests/torch_parity.py

# 3 channels per positional-conv group: the CPU's bf16 grouped conv is wrong
# at 2, 4 or 8 (tests/test_torch_mixed_precision.py)
WAVLM = dict(hidden=48, heads=2, intermediate=48, num_layers=2)


def tiny_cfg(**fields) -> Config:
    """The port's `parallel/tiny.py:tiny_config()` with a WavLM of WAVLM
    and SLM clips of 20 mel-half frames (12000 samples), which keep the
    pass's structure at half its CPU time (a step's own clips stay 40, the
    style encoder's least)."""
    cfg = tiny_config()
    cfg.model_params.slm.hidden = WAVLM["hidden"]
    cfg.slmadv_params.min_len, cfg.slmadv_params.max_len = 40, 80
    return dataclasses.replace(cfg, **fields)


@contextlib.contextmanager
def small_aux_builders():
    """`build_training_models` building WavLM of WAVLM and the small
    discriminators in place of the full ones."""
    saved = pbuild.WavLM, pbuild.MultiPeriodDiscriminator, pbuild.MultiResSpecDiscriminator
    pbuild.WavLM = lambda: WavLM(**WAVLM)
    pbuild.MultiPeriodDiscriminator = lambda: MultiPeriodDiscriminator(periods=(3,))
    pbuild.MultiResSpecDiscriminator = lambda: MultiResSpecDiscriminator(
        fft_sizes=(512,), hop_sizes=(50,), win_lengths=(240,))
    try:
        yield
    finally:
        pbuild.WavLM, pbuild.MultiPeriodDiscriminator, pbuild.MultiResSpecDiscriminator = saved


def tiny_models(cfg: Config, stage: str = "first"):
    """The stage's modules from seed 0 (`small_aux_builders`)."""
    with small_aux_builders():
        return pbuild.build_training_models(cfg, torch.Generator().manual_seed(0), stage)


def tiny_batch(n: int, seed: int = 0, wav_len: int = 36000) -> Batch:
    """n utterances of unequal lengths (mel 120 down to 90 frames), their
    waves zero beyond them, with reference texts and waves."""
    rng = np.random.default_rng(seed)
    top = wav_len // 300
    mel = np.asarray([top - 30 * i // max(n - 1, 1) for i in range(n)], np.int32) // 2 * 2
    waves = (0.2 * rng.standard_normal((n, wav_len))).astype(np.float32)
    waves[np.arange(wav_len)[None] >= (mel[:, None] * 300)] = 0.0
    lengths = rng.integers(8, 13, n).astype(np.int32)
    tokens = rng.integers(1, 178, (n, 12)).astype(np.int32)
    tokens[np.arange(12)[None] >= lengths[:, None]] = 0
    ref_lengths = rng.integers(7, 11, n).astype(np.int32)
    ref_tokens = rng.integers(1, 178, (n, 10)).astype(np.int32)
    ref_tokens[np.arange(10)[None] >= ref_lengths[:, None]] = 0
    return Batch(waves=waves, wave_lengths=mel * 300, tokens=tokens, input_lengths=lengths,
                 ref_tokens=ref_tokens, ref_lengths=ref_lengths, mel_lengths=mel,
                 ref_waves=waves.copy(), ref_wave_lengths=mel * 300,
                 speakers=np.zeros(n, np.int32))


def run_step(trainer_cls, cfg: Config, models, batch: Batch, epoch: int, seed: int = 3):
    """One train_step from a copy of `models`: (metrics, [{module: its
    flattened gradient} at each optimizer step], the state)."""
    models = copy.deepcopy(models)
    stage1 = trainer_cls is pstage1.Stage1Trainer
    state = TrainState(models, build_optimizers(cfg, models, stage2=not stage1), sigma_data=0.2)
    steps, module = [], pstage1 if stage1 else pstage2
    step_modules = module.step_modules

    def spy(ms, opts, keys):
        steps.append({k: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                    .detach().flatten().clone() for p in ms[k].parameters()])
                      for k in keys})
        step_modules(ms, opts, keys)

    module.step_modules = spy
    try:
        torch.manual_seed(0)
        metrics = trainer_cls(cfg, state, "cpu").train_step(batch, epoch, 0,
                                                            np.random.default_rng(seed))
    finally:
        module.step_modules = step_modules
    return metrics, steps, state
