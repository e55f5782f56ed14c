"""Training-throughput benchmark of the PyTorch port (the repository's
`bench_train.py`): steps/s, audio-hours/hour, FLOPs per step and MFU of the
stage-1 (TMA) or stage-2 (joint) step on synthetic batches.

    python -m styletts2_tpu_torch.bench_train [--stage first|second] [--batch B] \\
        [--steps N] [--full-size] [--mp bf16] [--remat] [--device cuda]
    python -m torch.distributed.run --nproc_per_node N \\
        -m styletts2_tpu_torch.bench_train --devices N ...

It runs on the card unless `--device cpu` is given, in f32 with TF32 off
(bf16 with `--mp bf16`). The default is `parallel/tiny.py`'s tiny widths
(`tiny_training_setup`, batch 2 of 1.1-1.2 s); `--full-size` is `Config()`
at the reference recipe's widths: batch 16, max_len 400 mel frames, the
real 12-layer WavLM, 110 text tokens, utterances of 5.25-6.2 s. `--stage
first` sets TMA_epoch 0 (the aligner, the GAN and the WavLM loss on),
`--stage second` diff_epoch and joint_epoch 0 (the diffusion and the SLM
adversarial pass on). Weights are seeded random (`training_setup`) and
the batch `synthetic_batch(default_rng(0), ...)`. One warm-up step is
timed alone (`compile_sec`, the JAX key: eager PyTorch compiles nothing,
it is the first step's wall), then `--steps` steps, each ending in a host
sync (the metrics), give `sec_per_step`.

`--devices N` runs as one of N ranks under `torch.distributed.run`, which
sets the world size (a `--devices` other than it raises): a (N / k, k)
mesh, k = 2 (model parallel) when N is even, as the JAX bench; each data
rank trains its rows of the global batch (`parallel/ddp.py`,
`parallel/mesh.py`); rank 0 prints.

FLOPs. The JAX bench reads XLA's `cost_analysis()` of the compiled step.
The port counts one more step after the timed ones, forward and backward,
with `torch.utils.flop_counter.FlopCounterMode`: 2 flops per multiply-add
of every matmul, convolution and attention (forward and both backward
products), summed over the ranks. The fused RNN ops, which it has no
formula for, get one (`RNN_FLOPS`): 2 * (|W_ih| + |W_hh|) per time step,
layer, direction and item forward (2 * 4H * (I + H) for an LSTM), twice
that backward; the LSTMCell steps are matmuls and counted as such. Nothing
else is counted: the elementwise work, FFTs and reductions (which XLA's
count includes), and K1 / K2, the hand-written AdaIN+snake kernels, count
0, as a Pallas custom call does in XLA's count. A recomputed forward
(`--remat`) is counted as run. MFU = flops_per_step / sec_per_step / (N *
the card's peak), the peak dense rate of the step's dtype from
`PEAK_FLOPS` (bf16 with `--mp bf16`, else f32 without TF32); a card not in
the table gives `mfu: null`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

# peak dense FLOP/s of one card, (bf16, f32 without tensor cores): NVIDIA's
# H100 data sheet; keyed by a substring of torch.cuda.get_device_name()
PEAK_FLOPS = {
    "H100 80GB HBM3": (989.4e12, 66.9e12),  # SXM
    "H100 PCIe": (756.5e12, 51.2e12),
}


def peak_for(name: str, bf16: bool) -> float:
    """The peak of the card named `name` in the step's dtype; 0.0 unknown."""
    for key, (p_bf16, p_f32) in PEAK_FLOPS.items():
        if key.lower() in name.lower():
            return p_bf16 if bf16 else p_f32
    return 0.0


def _tokens(shape, batch_sizes) -> int:
    """Time steps x items of an RNN input of `shape`: its first axis when
    packed (`batch_sizes` given), else its first two."""
    return int(shape[0]) if batch_sizes else int(shape[0]) * int(shape[1])


def _matrices(weights) -> int:
    """The elements of the weight matrices (2-D) in a list of shapes."""
    return sum(int(np.prod(w)) for w in weights if w is not None and len(w) == 2)


def _cudnn_rnn_flop(input, weight, *args, out_shape=None, **kwargs) -> int:
    batch_sizes = kwargs.get("batch_sizes", args[12] if len(args) > 12 else None)
    return 2 * _tokens(input, batch_sizes) * _matrices(weight)


def _cudnn_rnn_backward_flop(input, weight, *args, out_shape=None, **kwargs) -> int:
    batch_sizes = kwargs.get("batch_sizes", args[16] if len(args) > 16 else None)
    return 4 * _tokens(input, batch_sizes) * _matrices(weight)


def _mkldnn_rnn_layer_flop(input, w_ih, w_hh, *args, out_shape=None, **kwargs) -> int:
    return 2 * _tokens(input, None) * _matrices([w_ih, w_hh])


def _mkldnn_rnn_layer_backward_flop(input, w_ih, w_hh, *args, out_shape=None, **kwargs) -> int:
    return 4 * _tokens(input, None) * _matrices([w_ih, w_hh])


RNN_FLOPS = {
    torch.ops.aten._cudnn_rnn: _cudnn_rnn_flop,  # the card's fused LSTM
    torch.ops.aten._cudnn_rnn_backward: _cudnn_rnn_backward_flop,
    torch.ops.aten.mkldnn_rnn_layer: _mkldnn_rnn_layer_flop,  # the CPU's, one direction a call
    torch.ops.aten.mkldnn_rnn_layer_backward: _mkldnn_rnn_layer_backward_flop,
}


def count_flops(fn) -> int:
    """The FLOPs of `fn()` as the module docstring defines them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping=RNN_FLOPS) as counter:
        fn()
    return int(counter.get_total_flops())


def _rows(batch, rows: slice):
    """The batch's items `rows` (every field has the batch axis first)."""
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[rows]
                                         for f in dataclasses.fields(batch)})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=["first", "second"], default="first")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks under torch.distributed.run (its world size)")
    ap.add_argument("--batch", type=int, default=0, help="global batch; 0: 16 full-size, "
                                                         "else 2 or the data axis's size")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--full-size", action="store_true",
                    help="the reference's widths (batch 16, max_len 400, the real WavLM)")
    ap.add_argument("--mp", choices=["", "bf16"], default="",
                    help="mixed precision of the trainers (the config's mixed_precision)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint the decoder's Generator (the config's remat_decoder)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args) -> Dict:
    """Build, warm up, time and count as the module docstring says; returns
    the JSON object `main` prints (on every rank) and the trainer's last
    metrics under "metrics"."""
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.parallel import ddp, mesh
    from styletts2_tpu_torch.parallel.tiny import (synthetic_batch, tiny_config,
                                                   tiny_training_setup, training_setup)
    from styletts2_tpu_torch.utils import set_f32_compute

    set_f32_compute()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    if args.devices > 1:
        if not ddp.launched():
            raise SystemExit(f"--devices {args.devices}: run under python -m "
                             f"torch.distributed.run --nproc_per_node {args.devices}")
        device = ddp.init(device.type)
    if ddp.global_world() != args.devices:
        raise ValueError(f"--devices {args.devices}, but the world has {ddp.global_world()} ranks")
    m = mesh.make_mesh(args.devices, 2 if args.devices % 2 == 0 else 1)
    stage2 = args.stage == "second"
    cfg = Config() if args.full_size else tiny_config()
    cfg.mixed_precision = args.mp
    cfg.remat_decoder = args.remat
    if args.full_size:
        _, state = training_setup(cfg, stage2, device)
        wav_len, bucket, text = 126000, 150000, dict(T_text=110, T_buf=128)
    else:
        _, state = tiny_training_setup(cfg, stage2, device)
        wav_len, bucket, text = 27000, 48000, {}
    B = args.batch or (16 if args.full_size else (m.data if args.devices > 1 else 2))
    batch = synthetic_batch(np.random.default_rng(0), B, wav_len=wav_len, bucket=bucket, **text)
    audio_sec_per_step = float(np.sum(batch.wave_lengths)) / 24000.0
    b = ddp.local_batch_size(B, m.data)
    batch = _rows(batch, slice(m.data_rank * b, (m.data_rank + 1) * b))

    rng = np.random.default_rng(0)
    if stage2:
        from styletts2_tpu_torch.train.stage2 import Stage2Trainer

        cfg.loss_params.diff_epoch = cfg.loss_params.joint_epoch = 0
        trainer, it = Stage2Trainer(cfg, state, device), [0]

        def step():
            it[0] += 1
            return trainer.train_step(batch, 1, it[0], rng)
    else:
        from styletts2_tpu_torch.train.stage1 import Stage1Trainer

        cfg.loss_params.TMA_epoch = 0
        trainer = Stage1Trainer(cfg, state, device)

        def step():
            return trainer.train_step(batch, 1, 0, rng)

    t0 = time.perf_counter()
    metrics = step()  # the warm-up
    warm_sec = time.perf_counter() - t0
    if metrics is None:
        raise RuntimeError("the batch is too short to clip: no step was taken")
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step()
    dt = (time.perf_counter() - t0) / args.steps
    flops = count_flops(step)
    if args.devices > 1:  # every rank's share, its shards' and its rows' work
        total = torch.tensor([flops], dtype=torch.int64, device=ddp._device())
        torch.distributed.all_reduce(total)
        flops = int(total.item())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    peak = peak_for(name, bf16=args.mp == "bf16") * args.devices
    mfu: Optional[float] = flops / dt / peak if flops and peak else None
    return {
        "stage": args.stage,
        "devices": args.devices,
        "mesh": {"data": m.data, "model": m.model} if args.devices > 1 else None,
        "batch": B,
        "widths": "full" if args.full_size else "tiny",
        "mixed_precision": args.mp or "f32",
        "backend": device.type,
        "device_kind": name or device.type,
        "steps_per_sec": round(1.0 / dt, 4),
        "sec_per_step": round(dt, 4),
        "audio_hours_per_hour": round(audio_sec_per_step / dt, 2),
        "flops_per_step": flops or None,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "compile_sec": round(warm_sec, 1),
        "g_loss": round(float(metrics["g_loss"]), 4),
        "metrics": metrics,
    }


def main(argv=None):
    from styletts2_tpu_torch.parallel import ddp

    out = run(parse_args(argv))
    out.pop("metrics")
    if ddp.lead():
        print(json.dumps(out), flush=True)
    ddp.finish()


if __name__ == "__main__":
    main()
