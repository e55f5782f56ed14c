#!/usr/bin/env python3
"""Smoke run of the PyTorch port (styletts2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero:
  1. device: the card's name and power limit; TF32 off for convs and matmuls
  2. build: compile the CUDA kernel from styletts2_tpu_torch/csrc/
  3. kernel: the fused AdaIN+snake kernel against its plain PyTorch version
     at the main path's shapes, the JAX tests' shapes and an odd T; CUDA-event
     times of both at the two main-path shapes
  4. main path: full-width Config() synthesis with seeded random weights
     answers 3 requests; each waveform is finite, sum(durations) * 600 long,
     and its decode launched the kernel 48 times
  5. reference: a short request on the card agrees with the same weights on
     the CPU (plain version), random draws and the chaotic source phase zeroed
Then a JSON line of the kernels and, last, {"ok": true, "device": {...}}.
It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing a result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH_TEXT = (
    "ðɪ kwˈɪk bɹˈaʊn fˈɑːks dʒˈʌmps ˈoʊvɚ ðə lˈeɪzi dˈɔːɡ, "
    "ænd ðə sˈʌn sˈɛts slˈoʊli bɪhˈaɪnd ðə mˈaʊntənz."
)
REQUESTS = [
    (BENCH_TEXT, 0),
    ("ðɪs ɪz ɐ ʃˈɔːɹt ɹᵻkwˈɛst.", 1),
    ("hˈɪɹ ɪz ɐ lˈɔŋɡɚ wˈʌn, wɪð tˈuː klˈɔːzᵻz ænd ɐ kˈɑːmə.", 2),
]
TARGET_AUDIO_SEC = 8.0  # random-init durations run ~8x long; pin the length
CALLS_PER_DECODE = 48  # 8 AdaINResBlock1 x 3 dilations x 2
KERNEL_CASES = [  # (B, C, T), dtype name
    ((1, 256, 8000), "float32"),  # stage-0 blocks at an 8 s utterance (F = 400)
    ((1, 128, 48001), "float32"),  # stage-1 blocks: 120 F + 1
    ((2, 256, 24), "float32"),  # tests/test_pallas.py cases
    ((3, 256, 128), "float32"),
    ((2, 256, 160), "bfloat16"),
    ((2, 100, 37), "float32"),  # odd T below 64
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_draws(syn, text, noise, speed):
    """`syn.synthesize` with every random draw taken from one seeded CPU
    generator and the NSF source's STFT phase zeroed, so that two devices
    decode the same inputs. That phase is atan2 of ~0-magnitude bins and
    flips under any float reassociation; a random-init decoder amplifies the
    flip to O(1) (tests/torch_parity.py:stable_har_phase)."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    host = torch.Generator().manual_seed(0)
    rand, randn, magphase = torch.rand, torch.randn, pdi.stft_magphase

    def draw(fn):
        return lambda size, generator=None, device=None, dtype=None: fn(
            size, generator=host, dtype=dtype).to(device)

    def zero_phase(*a):
        mag, phase = magphase(*a)
        return mag, torch.zeros_like(phase)

    torch.rand, torch.randn, pdi.stft_magphase = draw(rand), draw(randn), zero_phase
    try:
        return syn.synthesize(text, noise=noise, speed=speed)
    finally:
        torch.rand, torch.randn, pdi.stft_magphase = rand, randn, magphase


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import SAMPLES_PER_FRAME, Synthesizer
    from styletts2_tpu_torch.ops import adain_snake as op

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = op.build()
    print(f"[2 build] {lib.relative_to(Path(op.__file__).resolve().parents[2])} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel vs plain
    g = torch.Generator(dev).manual_seed(0)
    max_err = 0.0
    timings = {}
    for (B, C, T), dt in KERNEL_CASES:
        dtype = getattr(torch, dt)
        x = (torch.randn((B, C, T), generator=g, device=dev) * 2 + 0.5).to(dtype)
        gamma = torch.randn((B, C), generator=g, device=dev) * 0.1
        beta = torch.randn((B, C), generator=g, device=dev) * 0.1
        alpha = torch.rand((C,), generator=g, device=dev) + 0.5
        with torch.inference_mode():
            got = op.adain_snake(x, gamma, beta, alpha)
            torch.cuda.synchronize()
            want = op.adain_snake_ref(x, gamma, beta, alpha)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dt], rtol=TOL[dt])
        line = f"[3 kernel] ({B},{C},{T}) {dt}: max_abs_err {err:.3e} (tol {TOL[dt]:g})"
        if dt == "float32":
            max_err = max(max_err, err)
        if (B, C, T) in ((1, 256, 8000), (1, 128, 48001)):
            with torch.inference_mode():
                run_k = lambda: op.adain_snake(x, gamma, beta, alpha)  # noqa: E731
                run_p = lambda: op.adain_snake_ref(x, gamma, beta, alpha)  # noqa: E731
                p1, k1, k2, p2 = _ms(run_p), _ms(run_k), _ms(run_k), _ms(run_p)
            timings[(B, C, T)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            line += f"; kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms [{smi}]"
        print(line, flush=True)

    # 4. main path
    t0 = time.perf_counter()
    syn = Synthesizer(Config(), seed=0, device=dev)
    n_params = sum(p.numel() for p in syn.models.parameters())
    print(f"[4 main] Synthesizer(Config()) on {dev}: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    natural = syn.synthesize(BENCH_TEXT, seed=0)  # calibration; also the warm-up
    speed = max(len(natural.wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
    plain_calls = []
    plain = op.adain_snake_ref
    op.adain_snake_ref = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    op.adain_snake.launches = 0
    try:
        for i, (text, seed) in enumerate(REQUESTS):
            before = op.adain_snake.launches
            t0 = time.perf_counter()
            r = syn.synthesize(text, seed=seed, speed=speed)
            lat = time.perf_counter() - t0
            n = op.adain_snake.launches - before
            audio = len(r.wav) / 24000.0
            if not np.isfinite(r.wav).all():
                raise RuntimeError(f"request {i}: non-finite waveform")
            if len(r.wav) != int(r.pred_dur.sum()) * SAMPLES_PER_FRAME:
                raise RuntimeError(f"request {i}: {len(r.wav)} samples for {r.pred_dur.sum()} frames")
            if n != CALLS_PER_DECODE:
                raise RuntimeError(f"request {i}: kernel launched {n} times, not {CALLS_PER_DECODE}")
            print(f"[4 main] request {i}: {len(r.pred_dur)} tokens, {int(r.pred_dur.sum())} frames, "
                  f"{audio:.3f} s audio, latency {lat * 1e3:.1f} ms, RTF {audio / lat:.2f}x, "
                  f"kernel launches {n} [{smi}]", flush=True)
    finally:
        op.adain_snake_ref = plain
    launches = op.adain_snake.launches
    if launches != CALLS_PER_DECODE * len(REQUESTS) or plain_calls:
        raise RuntimeError(f"main path: {launches} kernel launches, {len(plain_calls)} plain calls")
    print(f"[4 main] speed {speed:.3f} (natural {len(natural.wav) / 24000.0:.2f} s); "
          f"{launches} kernel launches, 0 plain-version calls", flush=True)

    # 5. reference: the same weights on the CPU, through the plain version
    ref_syn = Synthesizer(Config(), seed=0, device="cpu")
    noise = np.random.default_rng(0).standard_normal((1, 1, 256)).astype(np.float32)
    got = _host_draws(syn, REQUESTS[1][0], noise, speed)
    want = _host_draws(ref_syn, REQUESTS[1][0], noise, speed)
    if not np.array_equal(got.pred_dur, want.pred_dur):
        raise RuntimeError(f"durations differ: {got.pred_dur} vs {want.pred_dur}")
    if not (np.isfinite(got.wav).all() and np.isfinite(want.wav).all()):
        raise RuntimeError("non-finite waveform in the reference comparison")
    s_err = float(np.abs(got.s_pred - want.s_pred).max() / np.abs(want.s_pred).max())
    w_err = float(np.abs(got.wav - want.wav).max() / np.abs(want.wav).max())
    print(f"[5 reference] GPU vs CPU: durations equal, style rel err {s_err:.2e} (tol 1e-4), "
          f"waveform rel err {w_err:.2e} (tol 1e-3)", flush=True)
    if not (s_err < 1e-4 and w_err < 1e-3):
        raise RuntimeError("GPU and CPU disagree")

    k_ms, p_ms = timings[(1, 128, 48001)]
    print(json.dumps({"kernels": [{
        "name": "adain_snake", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/adain_snake.cu",
        "replaces": "styletts2_tpu/ops/pallas_kernels.py:38",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
