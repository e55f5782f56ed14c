"""Fused AdaIN + snake: the CUDA kernel, its wrapper and its plain version.

`adain_snake(x, gamma, beta, alpha)` computes, for x (B, C, T),
    snake((1 + gamma) * instance_norm_T(x) + beta, alpha)
with f32 math and the output in x's dtype. On a CUDA tensor it launches the
hand-written kernel in `csrc/adain_snake.cu` (built with nvcc at first use
into `_build/`, loaded through ctypes); on a CPU tensor it runs
`adain_snake_ref`, the plain PyTorch composition that the tests and
`chip_smoke.py` hold the kernel against. It never falls back from the
kernel: a CUDA input the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "adain_snake.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None  # the loaded library, after the first CUDA call


def adain_snake_ref(x, gamma, beta, alpha, eps: float = 1e-5):
    """Plain PyTorch version: x (B, C, T); gamma, beta (B, C); alpha (C,)."""
    xs = x.float()
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, unbiased=False, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps)
    y = (1.0 + gamma.float()[:, :, None]) * y + beta.float()[:, :, None]
    a = alpha.float()[None, :, None]
    s = torch.sin(a * y)
    return (y + (s * s) / a).to(x.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile csrc/adain_snake.cu into _build/ unless that source's library
    is already there (the file name hashes the source and the flags).
    Returns the library's path."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"adain_snake_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.adain_snake_forward
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _threads(T: int) -> int:
    return 1024 if T >= 8192 else 256


def adain_snake(x, gamma, beta, alpha):
    """Fused AdaIN + snake of x (B, C, T) f32/bf16 with gamma, beta (B, C)
    and alpha (C,). Kernel on CUDA, `adain_snake_ref` on CPU; inference only."""
    if any(t.requires_grad for t in (x, gamma, beta, alpha)):
        raise RuntimeError("adain_snake has no backward yet; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return adain_snake_ref(x, gamma, beta, alpha)
    if x.device.type != "cuda":
        raise RuntimeError(f"adain_snake: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"adain_snake: x must be (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adain_snake: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("adain_snake: x must be contiguous")
    if T < 1 or B * C < 1:
        raise ValueError(f"adain_snake: empty input {tuple(x.shape)}")
    if tuple(gamma.shape) != (B, C) or tuple(beta.shape) != (B, C) or tuple(alpha.shape) != (C,):
        raise ValueError(
            f"adain_snake: gamma/beta must be {(B, C)} and alpha {(C,)}, got "
            f"{tuple(gamma.shape)}, {tuple(beta.shape)}, {tuple(alpha.shape)}"
        )
    for t in (gamma, beta, alpha):
        if t.device != x.device or not t.is_floating_point():
            raise ValueError("adain_snake: gamma/beta/alpha must be floating tensors on x's device")
    # the per-row operands are tiny; the kernel reads them as contiguous f32
    g32, b32, a32 = (t.float().contiguous() for t in (gamma, beta, alpha))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _load().adain_snake_forward(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), a32.data_ptr(), out.data_ptr(),
            B, C, T, int(x.dtype == torch.bfloat16), _threads(T), stream,
        )
    if err != 0:
        raise RuntimeError(f"adain_snake kernel launch failed: cudaError {err}")
    adain_snake.launches += 1
    return out


adain_snake.launches = 0
