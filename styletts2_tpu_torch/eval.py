"""Fidelity metrics (`styletts2_tpu/eval.py`): mel-cepstral distortion, with
dynamic time warping for pairs of different lengths, and F0 RMSE with
voiced/unvoiced agreement.

`mcd` compares the mel-cepstra (c1..c13, the DCT-II of the log mel of the
port's front end, `preprocess_mel`) of two 24 kHz waveforms. Its DTW runs
the repository's C++ dynamic program (`native/dtw.cpp`, built with g++ at
first use into `_build/`, loaded through ctypes) on the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from styletts2_tpu_torch.ops.stft import MEL_MEAN, MEL_STD, preprocess_mel

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "dtw.cpp"
BUILD_DIR = _PKG / "_build"

_lib = None


def mfcc_from_wav(wav: np.ndarray, n_mfcc: int = 13) -> np.ndarray:
    """Mel-cepstra without c0 (T, n_mfcc) of a 24 kHz waveform: the DCT-II
    (orthonormal) of the front end's log mel."""
    with torch.no_grad():
        mel = preprocess_mel(torch.from_numpy(np.array(wav, np.float32)[None]))[0].numpy()
    logmel = mel * MEL_STD + MEL_MEAN  # undo the normalisation
    M = logmel.shape[0]
    n, k = np.arange(M), np.arange(n_mfcc + 1)
    dct = np.cos(np.pi / M * (n[:, None] + 0.5) * k[None, :]) * np.sqrt(2.0 / M)
    dct[:, 0] /= np.sqrt(2.0)
    return (logmel.T @ dct)[:, 1:]


def build() -> Path:
    """Compile the C++ DTW into _build/ unless that source's library is there."""
    h = hashlib.sha256(SOURCE.read_bytes() + b"-include cstddef").hexdigest()[:16]
    out = BUILD_DIR / f"dtw_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # the source uses size_t without <cstddef>, which newer g++ do not pull in
    res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-include", "cstddef", "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32, i32p = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
        lib.dtw_path.argtypes = [ctypes.POINTER(ctypes.c_float), i32, i32, i32, i32p, i32p]
        lib.dtw_path.restype = i32
        _lib = lib
    return _lib


def _distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distances (Ta, Tb) between the frames of a and b, f32."""
    return np.linalg.norm(a[:, None, :].astype(np.float32) - b[None, :, :].astype(np.float32),
                          axis=-1)


def dtw_path(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The least-cost warping path between the frames of a (Ta, D) and b
    (Tb, D): index arrays (ia, ib) from (0, 0) to (Ta - 1, Tb - 1), through
    the C++ DP."""
    Ta, Tb = len(a), len(b)
    if Ta == 0 or Tb == 0:
        raise ValueError(f"dtw_path: empty sequence ({Ta}, {Tb})")
    dist = np.ascontiguousarray(_distances(a, b), np.float32)
    pa, pb = np.empty(Ta + Tb, np.int32), np.empty(Ta + Tb, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = _load().dtw_path(dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), Ta, Tb, 0,
                         pa.ctypes.data_as(i32p), pb.ctypes.data_as(i32p))
    if n <= 0:
        raise RuntimeError(f"dtw_path: the DP found no path ({n})")
    return pa[:n].copy(), pb[:n].copy()


def mcd(wav_a: np.ndarray, wav_b: np.ndarray, use_dtw: bool = True) -> float:
    """Mel-cepstral distortion in dB between two 24 kHz waveforms: frames
    paired by DTW when their counts differ and `use_dtw`, else the common
    prefix."""
    ca, cb = mfcc_from_wav(wav_a), mfcc_from_wav(wav_b)
    if use_dtw and len(ca) != len(cb):
        ia, ib = dtw_path(ca, cb)
        ca, cb = ca[ia], cb[ib]
    else:
        n = min(len(ca), len(cb))
        ca, cb = ca[:n], cb[:n]
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0)
                 * np.mean(np.linalg.norm(ca - cb, axis=-1)))


def f0_metrics(f0_a: np.ndarray, f0_b: np.ndarray, voiced_threshold: float = 10.0) -> dict:
    """F0 RMSE in Hz over the frames both call voiced, and the share of
    frames whose voicing agrees, over the common prefix."""
    n = min(len(f0_a), len(f0_b))
    a, b = np.asarray(f0_a[:n]), np.asarray(f0_b[:n])
    va, vb = a > voiced_threshold, b > voiced_threshold
    both = va & vb
    rmse = float(np.sqrt(np.mean((a[both] - b[both]) ** 2))) if both.any() else 0.0
    return {"f0_rmse_hz": rmse, "vuv_accuracy": float(np.mean(va == vb)),
            "voiced_frames": int(both.sum())}
