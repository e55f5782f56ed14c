"""Step times and device-time breakdown of the port's training on one GPU.

    python3 tools/profile_torch_train.py [--stage first|second] [--steps 3] [--trace-dir DIR]
        [--mixed-precision bf16]

Full-width Config() (LJSpeech, iSTFTNet; batch 16, max_len 400, a clip of
200 half-frames) with seeded random weights, on chip_smoke.py's fixture of
32 seeded utterances of 6-9 s. For each phase of the stage (stage 1:
before TMA, then from TMA on; stage 2: before diffusion, with it, then
joint, where the SLM-adversarial pass runs): `--steps` steps timed on the
host clock (each ends in a host sync: the metrics are copied to the host)
and their peak memory, then one torch.profiler trace of a step (in the
joint phase, one that also steps the WavLM discriminator): kernel time by
op, kernel launches, the device busy share
(`observability.device_busy_ms` over the step's wall) and the host time,
kernel time and launches of the step's parts (the trainer's profiler
ranges). The profiler slows the host, so its wall exceeds the timed
steps'. `--trace-dir` keeps the Chrome traces. `--mixed-precision bf16`
trains as `mixed_precision: bf16` does (train/mp.py); convolutions and
matmuls run in f32 otherwise (TF32 off, as the entry points set it). Needs
a CUDA device.
"""

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from chip_smoke import training_fixture  # noqa: E402
from profile_torch_synth import stage_breakdown  # noqa: E402
from styletts2_tpu_torch.config import Config  # noqa: E402
from styletts2_tpu_torch.train.run import TRAINERS, setup  # noqa: E402
from styletts2_tpu_torch.utils import set_f32_compute  # noqa: E402

PARTS = ("forward", "discriminators", "adversarial", "backward", "optimizer", "slm", "slm_d")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("first", "second"), default="first")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace-dir", help="where to keep the Chrome traces")
    ap.add_argument("--mixed-precision", default="", choices=("", "bf16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    set_f32_compute()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config()
        cfg.data_params = training_fixture(Path(tmp) / "data")
        cfg.log_dir = str(Path(tmp) / "logs")
        cfg.mixed_precision = args.mixed_precision
        state, train_loader, _ = setup(cfg, torch.device("cuda"), logging.getLogger("profile"),
                                       args.stage)
        lp, wd_every = cfg.loss_params, cfg.slmadv_params.iter
        trainer = TRAINERS[args.stage](cfg, state, "cuda")
        # the WavLM discriminator steps when (i + 1) % iter == 0
        step = trainer.train_step
        phases = ((("pre-TMA", 0), ("TMA", lp.TMA_epoch)) if args.stage == "first" else
                  (("pre-diffusion", 0), ("diffusion", lp.diff_epoch), ("joint", lp.joint_epoch)))
        batches = list(train_loader)
        rng = np.random.default_rng(1)
        for phase, epoch in phases:
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for i in range(args.steps):
                t0 = time.perf_counter()
                step(batches[i % len(batches)], epoch, i, rng)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                metrics = step(batches[0], epoch, wd_every - 1, rng)
                wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
            trace = Path(args.trace_dir or tmp) / f"train_{phase}.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace))
            parts = stage_breakdown(trace, PARTS)
            print(json.dumps({"stage": args.stage, "phase": phase, "batch": cfg.batch_size,
                              "mixed_precision": cfg.mixed_precision or "f32",
                              "step_ms": step_ms, "metrics": metrics,
                              "peak_memory_gib": peak / 2 ** 30, "profiled_wall_ms": wall_ms,
                              "kernel_ms": parts["kernel_ms"],
                              "kernel_launches": parts["kernel_launches"],
                              "device_busy_share": parts["device_busy_ms"] / wall_ms,
                              "parts": parts["stages"], "top_kernels_ms": parts["top_kernels_ms"],
                              "device": smi}))


if __name__ == "__main__":
    main()
