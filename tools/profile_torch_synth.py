"""Latency and device-time breakdown of the PyTorch port's synthesis on one GPU.

    python3 tools/profile_torch_synth.py [--config ljspeech|libritts] [--repeats 10]
        [--trace synth_trace.json] [--decoder-dtype bfloat16]

Full-width Config() (LJSpeech, iSTFTNet) or libritts_config() (multispeaker,
HiFi-GAN, with the style of chip_smoke.py's seeded voice), seeded random
weights, the requests of chip_smoke.py with the speed pinned to ~8 s for
the first. For each request: warm-up
calls at its shapes, then the median, min and max host latency of
`--repeats` calls (each ends in a device sync: the waveform is copied to
the host). Then one torch.profiler trace of the first request: kernel
time by op, kernel launches, the device busy share
(`observability.device_busy_ms` over the profiled call's wall) and each
synthesis stage's host time, kernel time and launches (each stage is one
CUDA graph replay; its kernels belong to the span of their graph's launch). The profiler
slows the host, so its wall time exceeds the warm latency. `--trace` keeps
the Chrome trace. `--decoder-dtype bfloat16` runs the bf16 decoder;
convolutions and matmuls are f32 otherwise (TF32 off, as the entry points
set it). Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import BENCH_TEXT, REQUESTS, TARGET_AUDIO_SEC, _voice  # noqa: E402
from styletts2_tpu_torch.config import Config, libritts_config  # noqa: E402
from styletts2_tpu_torch.inference import Synthesizer  # noqa: E402
from styletts2_tpu_torch.observability import device_busy_ms  # noqa: E402
from styletts2_tpu_torch.utils import set_f32_compute  # noqa: E402

STAGES = ("text", "style", "duration", "phase_a", "prosody", "decode")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("ljspeech", "libritts"), default="ljspeech")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--trace", help="where to keep the Chrome trace")
    ap.add_argument("--decoder-dtype", default=None, choices=["bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    set_f32_compute()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.config == "libritts":
        syn = Synthesizer(libritts_config(), seed=0, device="cuda", decoder_dtype=args.decoder_dtype)
        kw = {"ref_s": syn.compute_style(_voice())}
    else:
        syn = Synthesizer(Config(), seed=0, device="cuda", decoder_dtype=args.decoder_dtype)
        kw = {}
    speed = max(len(syn.synthesize(BENCH_TEXT, **kw).wav) / 24000.0 / TARGET_AUDIO_SEC, 1.0)
    for i, (text, seed) in enumerate(REQUESTS):
        for _ in range(3):
            syn.synthesize(text, seed=seed, speed=speed, **kw)
        lat = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            r = syn.synthesize(text, seed=seed, speed=speed, **kw)
            lat.append(time.perf_counter() - t0)
        audio = len(r.wav) / 24000.0
        med = float(np.median(lat))
        print(json.dumps({"config": args.config, "decoder_dtype": args.decoder_dtype or "float32",
                          "request": i, "audio_s": audio,
                          "frames": int(r.pred_dur.sum()),
                          "latency_ms_median": med * 1e3, "latency_ms_min": min(lat) * 1e3,
                          "latency_ms_max": max(lat) * 1e3, "rtf": audio / med, "device": smi}))

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        syn.synthesize(BENCH_TEXT, seed=0, speed=speed, **kw)
        wall_us = (time.perf_counter() - t0) * 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(args.trace) if args.trace else Path(tmp) / "trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        breakdown = stage_breakdown(trace)
    print(json.dumps({"config": args.config, "decoder_dtype": args.decoder_dtype or "float32",
                      "wall_ms": wall_us / 1e3, **breakdown,
                      "device_busy_share": breakdown["device_busy_ms"] / (wall_us / 1e3),
                      "device": smi}))


def stage_breakdown(trace: Path, names=STAGES) -> dict:
    """Kernel time and launches under each span of `names`, from the Chrome
    trace: a kernel belongs to the span that was open when it was launched;
    and the card's busy ms (`device_busy_ms`)."""
    ev = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "user_annotation" and e["name"] in names]
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    stages = {s["name"]: {"host_ms": s["dur"] / 1e3, "kernel_ms": 0.0, "launches": 0} for s in spans}
    by_name = {}
    for k in kernels:
        ts = launched.get(k["args"]["correlation"], k["ts"])
        owner = next((s["name"] for s in spans if s["ts"] <= ts <= s["ts"] + s["dur"]), None)
        if owner is not None:
            stages[owner]["kernel_ms"] += k["dur"] / 1e3
            stages[owner]["launches"] += 1
        by_name[k["name"][:48]] = by_name.get(k["name"][:48], 0.0) + k["dur"] / 1e3
    kernel_ms = sum(k["dur"] for k in kernels) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"kernel_ms": kernel_ms, "kernel_launches": len(kernels),
            "device_busy_ms": device_busy_ms(ev), "stages": stages, "top_kernels_ms": top}


if __name__ == "__main__":
    main()
