"""Monotonic alignment: the hard Viterbi path through a soft attention map
(`styletts2_tpu/ops/align.py:29-84`).

`maximum_path` runs the repository's C++ dynamic program
(`native/monotonic_align.cpp`, built with g++ at first use into `_build/`,
loaded through ctypes) on the host, as the reference's round trip did:
value[i, j] = score[i, j] + max(value[i-1, j-1], value[i, j-1]), then the
backtrack from (text_len - 1, mel_len - 1), staying on ties.
`maximum_path_ref` is the plain torch port of the JAX package's two scans
(forward DP and backtrack), the oracle the tests hold the C++ path to.
The DP is no Pallas kernel in the JAX package, so it has no CUDA kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "monotonic_align.cpp"
BUILD_DIR = _PKG / "_build"
_NEG_INF = -1e9

_lib = None


def build() -> Path:
    """Compile the C++ DP into _build/ unless that source's library is there."""
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"monotonic_align_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.maximum_path_batch.argtypes = [i32p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, i32p, i32p]
        lib.maximum_path_batch.restype = None
        _lib = lib
    return _lib


def maximum_path(scores: torch.Tensor, text_lengths, mel_lengths) -> torch.Tensor:
    """scores (B, T_text, T_mel); lengths (B,) -> the 0/1 path (B, T_text,
    T_mel) in scores' dtype, on scores' device, without gradient."""
    B, T_text, T_mel = scores.shape
    neg = np.ascontiguousarray(scores.detach().float().cpu().numpy())
    tl = np.ascontiguousarray(np.asarray(torch.as_tensor(text_lengths).cpu(), np.int32))
    ml = np.ascontiguousarray(np.asarray(torch.as_tensor(mel_lengths).cpu(), np.int32))
    if tl.shape != (B,) or ml.shape != (B,):
        raise ValueError(f"maximum_path: lengths must be ({B},), got {tl.shape}, {ml.shape}")
    if (tl > T_text).any() or (ml > T_mel).any():
        raise ValueError("maximum_path: a length exceeds the score map")
    path = np.zeros((B, T_text, T_mel), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _load().maximum_path_batch(path.ctypes.data_as(i32p),
                               neg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               B, T_text, T_mel, tl.ctypes.data_as(i32p), ml.ctypes.data_as(i32p))
    return torch.from_numpy(path).to(scores.device, scores.dtype)


@torch.no_grad()
def maximum_path_ref(scores: torch.Tensor, text_lengths, mel_lengths) -> torch.Tensor:
    """Plain torch port of the JAX scans: the same path as `maximum_path`."""
    B, T_text, T_mel = scores.shape
    dev = scores.device
    text_lengths = torch.as_tensor(text_lengths, device=dev)
    mel_lengths = torch.as_tensor(mel_lengths, device=dev)
    i_idx = torch.arange(T_text, device=dev)
    v = torch.full((B, T_text), _NEG_INF, dtype=scores.dtype, device=dev)
    take_diag = []
    for j in range(T_mel):
        s = scores[:, :, j]
        if j == 0:
            v = torch.where(i_idx[None] == 0, s, torch.full_like(s, _NEG_INF))
            take_diag.append(torch.zeros_like(s, dtype=torch.bool))
            continue
        v_diag = torch.cat([torch.full((B, 1), _NEG_INF, dtype=v.dtype, device=dev), v[:, :-1]], 1)
        take_diag.append(v_diag > v)  # strict: stay on ties
        v = torch.where(i_idx[None] <= j, s + torch.maximum(v_diag, v),
                        torch.full_like(s, _NEG_INF))
    path = torch.zeros((B, T_text, T_mel), dtype=scores.dtype, device=dev)
    i_cur = torch.where(mel_lengths > 0, text_lengths - 1, torch.full_like(text_lengths, -1))
    rows = torch.arange(B, device=dev)
    for j in range(T_mel - 1, -1, -1):
        active = (j < mel_lengths) & (i_cur >= 0)
        path[rows[active], i_cur[active], j] = 1.0
        came_diag = take_diag[j][rows, i_cur.clamp(min=0)]
        i_cur = torch.where(active & came_diag, i_cur - 1, i_cur)
    return path
