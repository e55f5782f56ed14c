"""The benchmark's arithmetic: percentiles, the device's busy time in a
trace, the card's peaks, the FLOPs of a request and K1's bytes.

Copies, kept here so that a change to the program cannot change the
yardstick: `device_busy_ms` is `styletts2_tpu_torch/observability.py`'s,
`PEAK_FLOPS` and `RNN_FLOPS` are `styletts2_tpu_torch/bench_train.py`'s
(FLOPs by `FlopCounterMode` plus 2 * |W| per LSTM step and direction), the
bandwidth and the rule of counting each byte once are `chip_smoke.py`'s
`bound_ms`.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# peak dense FLOP/s of one card, (bf16, f32 without tensor cores): NVIDIA's
# H100 data sheet; keyed by a substring of torch.cuda.get_device_name()
PEAK_FLOPS = {
    "H100 80GB HBM3": (989.4e12, 66.9e12),  # SXM
    "H100 PCIe": (756.5e12, 51.2e12),
}
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device categories
K1_KERNEL = "adain_snake_kernel"  # the forward AdaIN+snake kernel's name in a trace


def peak_f32(name: str) -> float:
    """The f32 (TF32 off) peak of the card named `name`; 0.0 if unknown."""
    for key, (_, p32) in PEAK_FLOPS.items():
        if key.lower() in name.lower():
            return p32
    return 0.0


# ---------------------------------------------------------------------------
# latencies

def percentile(latencies: Sequence[Optional[float]], p: float) -> float:
    """The nearest-rank p-th percentile of `latencies`, where None (a
    request that failed or never finished) ranks above every number; the
    percentile of such a request is +inf."""
    if not latencies:
        raise ValueError("no requests")
    ranked = sorted(latencies, key=lambda v: (v is None, v if v is not None else 0.0))
    v = ranked[max(0, math.ceil(p / 100.0 * len(ranked)) - 1)]
    return math.inf if v is None else v


# ---------------------------------------------------------------------------
# traces

def intervals(events: Iterable[dict]) -> List[Tuple[float, float]]:
    """The union of the device's work intervals (us) in Chrome trace events."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in DEVICE_WORK):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def device_busy_ms(events) -> float:
    """The card's busy time (ms) in a Chrome trace's `traceEvents`: the
    union of its kernels', copies' and memsets' intervals over every
    stream, so that kernels overlapping on two streams count once."""
    return sum(b - a for a, b in intervals(events)) / 1e3


def busy_within(merged: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """us of the merged intervals inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


# ---------------------------------------------------------------------------
# FLOPs

def _tokens(shape, batch_sizes) -> int:
    return int(shape[0]) if batch_sizes else int(shape[0]) * int(shape[1])


def _matrices(weights) -> int:
    return sum(int(np.prod(w)) for w in weights if w is not None and len(w) == 2)


def _cudnn_rnn_flop(input, weight, *args, out_shape=None, **kwargs) -> int:
    batch_sizes = kwargs.get("batch_sizes", args[12] if len(args) > 12 else None)
    return 2 * _tokens(input, batch_sizes) * _matrices(weight)


def _mkldnn_rnn_layer_flop(input, w0, w1, *args, out_shape=None, **kwargs) -> int:
    return 2 * int(input[0]) * int(input[1]) * (int(np.prod(w0)) + int(np.prod(w1)))


RNN_FLOPS = {
    torch.ops.aten._cudnn_rnn: _cudnn_rnn_flop,
    torch.ops.aten.mkldnn_rnn_layer: _mkldnn_rnn_layer_flop,
}


def count_flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping=RNN_FLOPS) as counter:
        fn()
    return int(counter.get_total_flops())


class FlopModel:
    """FLOPs of one request synthesized alone at its own L tokens (the pad
    in front included) and F frames: exactly c0 + c1 L + c2 L^2 + c3 F +
    c4 L F (projections and LSTMs in L, attention in L^2, the alignment's
    products in L F, the prosody's and the decoder's convolutions and LSTM
    in F), fitted to `FlopCounterMode` counts of the reference at six small
    shapes."""

    POINTS = ((8, 10), (8, 30), (24, 10), (24, 30), (40, 20), (56, 40))

    def __init__(self, coef: np.ndarray):
        self.coef = coef

    @staticmethod
    def terms(L, F):
        L, F = np.asarray(L, np.float64), np.asarray(F, np.float64)
        return np.stack([np.ones_like(L * F), L, L * L, F, L * F], axis=-1)

    @classmethod
    def fit(cls, ref) -> "FlopModel":
        counts = [count_reference(ref, L, F) for L, F in cls.POINTS]
        L, F = zip(*cls.POINTS)
        coef, *_ = np.linalg.lstsq(cls.terms(L, F), np.asarray(counts, np.float64), rcond=None)
        return cls(coef)

    def __call__(self, L, F) -> np.ndarray:
        return self.terms(L, F) @ self.coef


@torch.inference_mode()
def count_reference(ref, L: int, F: int) -> int:
    """`FlopCounterMode`'s count of the reference `ref` synthesizing one
    request of L tokens and F frames on its device."""
    dev, sdim = ref.device, ref.sdim
    feats = torch.zeros(1, 2 * sdim, device=dev) if ref.multispeaker else None

    def run():
        tokens = torch.ones(1, L, dtype=torch.int64, device=dev)
        lengths = torch.tensor([L])
        noise = torch.zeros(1, 1, 2 * sdim, device=dev)
        t_en, d, s, rstyle, _ = ref.phase_a(tokens, lengths, noise, feats, 0.3, 0.7, 5, 1.0,
                                            None, 0.2)
        pd = torch.ones(1, L, dtype=torch.int64, device=dev)
        asr, F0, N = ref.prosody(t_en, d, s, pd, F)
        ref.decode(asr, F0, N, rstyle, None)

    return count_flops(run)


# ---------------------------------------------------------------------------
# K1's bytes

def k1_sites(cfg: dict, frames: int) -> List[Tuple[int, int]]:
    """(C, T) of every AdaIN+snake the decoder runs for one request of
    `frames` frames, from the Generator's published widths and rates:
    stage i has C = ch0 / 2^(i+1) channels at 2 F prod(rates[:i+1])
    samples (the iSTFTNet's last stage one more, its reflection pad), and
    (1 noise resblock + the resblocks) x dilations x 2 sites."""
    dec = cfg["model_params"]["decoder"]
    rates, ch0 = dec["upsample_rates"], dec["upsample_initial_channel"]
    per_stage = (1 + len(dec["resblock_kernel_sizes"])) * 2 * len(dec["resblock_dilation_sizes"][0])
    out = []
    for i in range(len(rates)):
        T = 2 * frames * int(np.prod(rates[: i + 1]))
        if dec["type"] == "istftnet" and i == len(rates) - 1:
            T += 1
        out += [(ch0 // 2 ** (i + 1), T)] * per_stage
    return out


def k1_bytes(cfg: dict, frames: int, itemsize: int = 4) -> int:
    """The bytes K1 needs for one request: x read once and y written once,
    gamma and beta (C each) and alpha (C) read once, per site."""
    return sum(itemsize * (2 * C * T + 3 * C) for C, T in k1_sites(cfg, frames))
