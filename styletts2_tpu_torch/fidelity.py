"""Fidelity on trained weights (`tools/train_tiny_fidelity.py`).

    python -m styletts2_tpu_torch.fidelity [--config ljspeech|libritts|tiny] [--steps 300] \\
        [--batch 2] [--wav-len N] [--mcd-every 50] [--out DIR] [--device cuda]

A random-init decoder is chaotic (the iSTFT head's exp, the NSF source), so
an MCD measured on it bounds chaos, not precision. This trains stage 1
before TMA (`TMA_epoch` = 10**9: the generator loss is the mel loss alone,
the reference's `train_first.py` pre-TMA phase) on harmonic pseudo-speech
(`speechlike_batch`) through `train/stage1.py:Stage1Trainer.train_step` in
f32 with TF32 off, and measures:

- the mel loss of every step (the means of the first and last 10, the drop);
- the bf16-vs-f32 decoder MCD on a held-out batch (`decoder_mcd_f32_vs_bf16`)
  at random init, every `--mcd-every` steps and after the last step.

`--config ljspeech` is `Config()` (iSTFTNet) and `--config libritts`
`libritts_config()` (HiFi-GAN), both at full width; `tiny` is
`parallel/tiny.py:tiny_config()` with three dilations per resblock, as the
JAX tool runs it. The training batches come from numpy's `default_rng(3)`,
the held-out batch from `default_rng(999)`, as in the JAX tool; the model's
weights and dropout's draws from seed 0. `--wav-len` defaults to 27000 samples for `tiny` and to
120600 at full width, where every utterance is then long enough for
`Config()`'s 200-frame (5 s) clips. `fidelity.json` in `--out` holds the
JAX tool's keys (unrounded), the config, device, the MCD curve and, on a
card, its name and power limit as nvidia-smi reports them. It runs on the
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from styletts2_tpu_torch.config import Config, libritts_config
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.eval import mcd
from styletts2_tpu_torch.inference import decode
from styletts2_tpu_torch.models.build import build_training_models
from styletts2_tpu_torch.parallel.tiny import tiny_config
from styletts2_tpu_torch.train.stage1 import Stage1Trainer, clip_length
from styletts2_tpu_torch.train.state import TrainState, build_optimizers
from styletts2_tpu_torch.utils import set_f32_compute

CONFIGS: Dict[str, Callable[[], Config]] = {"ljspeech": Config, "libritts": libritts_config,
                                            "tiny": tiny_config}
WAV_LEN = {"tiny": 27000, "ljspeech": 120600, "libritts": 120600}
TRAIN_SEED, HELD_OUT_SEED = 3, 999
PRE_TMA = 10 ** 9


def _speechlike(n, f0, harmonics, env, noise, sr=24000) -> np.ndarray:
    """One item of `speechlike_batch` from its draws."""
    t = np.arange(n) / sr
    f0 = 120.0 + 60.0 * np.sin(2 * np.pi * f0[0] * t) + f0[1]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = np.zeros(n)
    for h, offset in enumerate(harmonics, start=1):
        sig += np.sin(h * phase + offset) / h
    env = 0.4 + 0.6 * np.clip(np.sin(2 * np.pi * env[0] * t + env[1]), 0, None)
    sig = sig * env + 0.01 * noise
    return (0.3 * sig / (np.abs(sig).max() + 1e-6)).astype(np.float32)


def speechlike_batch(rng: np.random.Generator, B: int, bucket: int = 48000, wav_len: int = 27000,
                     T_text: int = 12) -> Batch:
    """Harmonic pseudo-speech: an F0 contour, 8 decaying harmonics, breath
    noise and a syllabic envelope, `wav_len` to `wav_len` + 3000 samples
    in a bucket of `bucket`; random texts of T_text tokens. The JAX tool's
    draws, in its order: for the same `rng` state its arrays are bit-equal.
    The draws come first, one item after the other; the items' signals are
    then computed on threads (numpy's ufuncs release the GIL), each with
    the JAX tool's operations in its order."""
    draws = []
    for _ in range(B):
        n = wav_len + int(rng.integers(0, 3000))
        f0 = (rng.uniform(0.5, 2.0), rng.uniform(-20, 40))
        harmonics = [rng.uniform(0, 2 * np.pi) for _ in range(8)]
        env = (rng.uniform(2.0, 5.0), rng.uniform(0, 6))
        draws.append((n, f0, harmonics, env, rng.standard_normal(n)))
    with ThreadPoolExecutor(min(B, os.cpu_count() or 1)) as pool:
        sigs = list(pool.map(lambda d: _speechlike(*d), draws))
    waves = np.zeros((B, bucket), np.float32)
    wave_lengths = np.zeros(B, np.int32)
    mel_lengths = np.zeros(B, np.int32)
    for b, sig in enumerate(sigs):
        n = len(sig)
        waves[b, :n] = sig
        wave_lengths[b] = n
        ml = n // 300 + 1
        mel_lengths[b] = ml - ml % 2
    tokens = np.zeros((B, 32), np.int32)
    tokens[:, :T_text] = rng.integers(4, 178, (B, T_text))
    input_lengths = np.full(B, T_text, np.int32)
    return Batch(waves=waves, wave_lengths=wave_lengths, tokens=tokens,
                 input_lengths=input_lengths, ref_tokens=tokens, ref_lengths=input_lengths,
                 mel_lengths=mel_lengths, ref_waves=waves[:, :24000].copy(),
                 ref_wave_lengths=np.full(B, 24000, np.int32), speakers=np.zeros(B, np.int32))


def fidelity_config(name: str) -> Config:
    """The config `name` (ljspeech, libritts or tiny) trained before TMA."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}: one of {sorted(CONFIGS)}")
    cfg = CONFIGS[name]()
    cfg.loss_params.TMA_epoch = PRE_TMA
    if name == "tiny":  # three dilations, as the JAX tool and the reference's AdaINResBlock1
        cfg.model_params.decoder.resblock_dilation_sizes = [[1, 3, 5]]
    return cfg


def build_trainer(cfg: Config, device, seed: int = 0) -> Stage1Trainer:
    """A stage-1 trainer over modules with seeded random weights on `device`;
    dropout's draws from torch's global generator, seeded here too (as
    `train/run.py:setup` seeds it), so a run repeats in any process."""
    torch.manual_seed(seed)
    models = build_training_models(cfg, torch.Generator().manual_seed(seed), "first").to(device)
    return Stage1Trainer(cfg, TrainState(models, build_optimizers(cfg, models)), device)


@torch.no_grad()
def decoder_io(trainer: Stage1Trainer, batch: Batch, seed: int = 0):
    """The decoder's inputs (en, F0, norm, s) of the held-out batch's
    eval-mode reconstruction: the monotonic path, clips from frame 0 of
    the trainer's clip length, the draws from `seed`."""
    clip_len = clip_length(trainer.cfg, batch.mel_lengths)
    if clip_len is None:
        raise ValueError(f"held-out batch too short to clip: mel lengths {batch.mel_lengths}")
    starts = np.zeros(len(batch.mel_lengths), np.int64)
    trainer._modes(False, ())
    _, _, aux = trainer.forward_recon(*trainer._tensors(batch), starts, starts, clip_len, True,
                                      torch.Generator(trainer.device).manual_seed(seed))
    return aux["decoder_io"]


@torch.no_grad()
def decoder_mcd_f32_vs_bf16(trainer: Stage1Trainer, batch: Batch,
                            seed: int = 0) -> Tuple[float, List[float], float]:
    """The held-out reconstruction decoded by the trainer's decoder in f32
    and by a copy with bf16 weights through `inference.decode` (the bf16
    serving path's cast of the weights and inputs, its f32 islands kept),
    the NSF source's draws from one seed on both: (mean MCD in dB without
    DTW, per item, the share of the f32 waveform's samples at |y| >= 0.99:
    where HiFi-GAN's tanh head saturates, its gradient is ~0)."""
    en, f0, norm, s = decoder_io(trainer, batch, seed)
    dec = trainer.models["decoder"]
    dec16 = copy.deepcopy(dec).to(torch.bfloat16)
    dev = trainer.device
    y32 = decode(dec, en, f0, norm, s, torch.Generator(dev).manual_seed(seed)).cpu().numpy()
    y16 = decode(dec16, en, f0, norm, s, torch.Generator(dev).manual_seed(seed)).cpu().numpy()
    del dec16
    scores = [float(mcd(y16[b], y32[b], use_dtw=False)) for b in range(len(y32))]
    return float(np.mean(scores)), scores, float(np.mean(np.abs(y32) >= 0.99))


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def run(config: str = "tiny", steps: int = 300, batch: int = 2, wav_len: Optional[int] = None,
        device="cuda", mcd_every: int = 50, log: Callable[[str], None] = print) -> dict:
    """Train `config` for `steps` pre-TMA steps at `batch` and measure; the
    result is what `fidelity.json` holds. cuDNN runs its deterministic
    algorithms meanwhile: with dropout seeded too, a run repeats on the same
    card and software (their atomic sums otherwise move the trained MCD by
    a few tenths of a dB from run to run)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"fidelity: device {device}: no CUDA device is available")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _run(config, steps, batch, wav_len, device, mcd_every, log)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn


def _run(config, steps, batch, wav_len, device, mcd_every, log) -> dict:
    wav_len = wav_len or WAV_LEN[config]
    bucket = max(48000, wav_len + 3000)
    cfg = fidelity_config(config)
    trainer = build_trainer(cfg, device)
    rng = np.random.default_rng(TRAIN_SEED)
    held_out = speechlike_batch(np.random.default_rng(HELD_OUT_SEED), batch, bucket, wav_len)
    mcd0, items0, sat0 = decoder_mcd_f32_vs_bf16(trainer, held_out)
    curve = [[0, mcd0]]
    log(f"fidelity {config}: random init bf16-vs-f32 MCD {mcd0:.4f} dB")
    losses, step_ms = [], []
    for it in range(steps):
        b = speechlike_batch(rng, batch, bucket, wav_len)
        t0 = time.perf_counter()
        m = trainer.train_step(b, 0, it, rng)  # ends in a host sync (the metrics)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if m is None:
            continue
        losses.append(float(m["mel"]))
        if (it + 1) % mcd_every == 0 and it + 1 < steps:
            curve.append([it + 1, decoder_mcd_f32_vs_bf16(trainer, held_out)[0]])
            log(f"fidelity {config}: step {it + 1} mel {losses[-1]:.4f}, bf16-vs-f32 MCD "
                f"{curve[-1][1]:.4f} dB")
        elif it % 25 == 0:
            log(f"fidelity {config}: step {it} mel {losses[-1]:.4f}")
    mcd1, items, sat1 = decoder_mcd_f32_vs_bf16(trainer, held_out)
    curve.append([steps, mcd1])
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    result = {
        "config": config, "device": str(device), "steps": steps, "batch": batch,
        "wav_len": wav_len,
        "mel_loss_first10": first, "mel_loss_last10": last,
        "mel_loss_drop_pct": 100 * (first - last) / max(first, 1e-8),
        "bf16_vs_f32_mcd_dB_random_init": mcd0,
        "bf16_vs_f32_mcd_dB_random_init_per_item": items0,
        "bf16_vs_f32_mcd_dB_trained": mcd1,
        "bf16_vs_f32_mcd_dB_trained_per_item": items,
        "bf16_vs_f32_mcd_dB_curve": curve,
        "saturated_share_random_init": sat0, "saturated_share_trained": sat1,
        "mel_losses": losses,
        "step_ms_median": float(np.median(step_ms[1:] if len(step_ms) > 1 else step_ms)),
    }
    if device.type == "cuda":
        result["card"] = card()
        result["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    log(f"fidelity {config}: mel {first:.4f} -> {last:.4f}; bf16-vs-f32 MCD {mcd0:.4f} dB at "
        f"random init, {mcd1:.4f} dB trained")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="styletts2_tpu_torch trained-weights fidelity")
    ap.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--wav-len", type=int, default=None,
                    help="shortest utterance in samples (default: 27000 tiny, 120600 full width)")
    ap.add_argument("--mcd-every", type=int, default=50)
    ap.add_argument("--out", default="fidelity_out")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_f32_compute()
    result = run(args.config, args.steps, args.batch, args.wav_len, args.device, args.mcd_every)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "fidelity.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "mel_losses"}))
    return result


if __name__ == "__main__":
    main()
