"""Fused AdaIN + snake: the CUDA kernels, their wrappers and plain versions.

`adain_snake(x, gamma, beta, alpha)` computes, for x (B, C, T),
    snake((1 + gamma) * instance_norm_T(x) + beta, alpha)
with f32 math and the output in x's dtype. On a CUDA tensor it launches the
hand-written forward kernel in `csrc/adain_snake.cu` (built with nvcc at
first use into `_build/`, loaded through ctypes); on a CPU tensor it runs
`adain_snake_ref`, the plain PyTorch composition that the tests and
`chip_smoke.py` hold the kernel against. When an input needs a gradient it
goes through `AdainSnake`, a `torch.autograd.Function` (the JAX package's
custom VJP `_adain_snake_pallas`, `styletts2_tpu/ops/pallas_kernels.py:108-164`)
whose backward is the hand-written backward kernel on CUDA tensors and
`adain_snake_bwd_ref`, the plain port of `_bwd`, on CPU tensors. Nothing
falls back from a kernel: a CUDA input a kernel cannot take, or a launch
the card refuses, raises. Both kernels split each (b, c) row over a
thread-block cluster of `_plan(...).k` blocks that hold their slices in
shared memory. `adain_snake.launches` counts forward launches,
`adain_snake.bwd_launches` backward ones. A launch that a CUDA graph
captures counts when the graph replays it (`recorded`, `replayed`): the
launch goes to the current stream, the capture's while it captures.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

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


def adain_snake_bwd_ref(x, gamma, beta, alpha, dy, eps: float = 1e-5):
    """Plain PyTorch port of the JAX `_bwd` (`pallas_kernels.py:117-161`):
    the analytic VJP with every statistic recomputed and all math in f32;
    returns (dx, dgamma, dbeta, dalpha) in the primal dtypes."""
    dts = (x.dtype, gamma.dtype, beta.dtype, alpha.dtype)
    x, gamma, beta, alpha, dy = (t.float() for t in (x, gamma, beta, alpha, dy))
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    g1 = 1.0 + gamma[:, :, None]
    z = g1 * xhat + beta[:, :, None]
    a = alpha[None, :, None]
    s2az = torch.sin(2.0 * a * z)
    dz = dy * (1.0 + s2az)
    saz = torch.sin(a * z)
    dalpha = (dy * (z * s2az / a - (saz * saz) / (a * a))).sum(dim=(0, 2))
    dgamma = (dz * xhat).sum(dim=-1)
    dbeta = dz.sum(dim=-1)
    dz_g = dz * g1
    dx = inv * (dz_g - dz_g.mean(dim=-1, keepdim=True)
                - xhat * (dz_g * xhat).mean(dim=-1, keepdim=True))
    return tuple(t.to(dt) for t, dt in zip((dx, dgamma, dbeta, dalpha), dts))


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
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        plan = [i32, i32, i64, i32, i32, i64, i32, i32, vp]  # B, C, T, is_bf16, plan, stream
        lib.adain_snake_forward.argtypes = [vp] * 5 + plan
        lib.adain_snake_backward.argtypes = [vp] * 9 + plan
        lib.adain_snake_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.adain_snake_forward.restype = lib.adain_snake_backward.restype = ctypes.c_int
        lib.adain_snake_limits.restype = ctypes.c_int
        _lib = lib
    return _lib


MIN_SLICE = 1024  # elements below which a row is not split further


class Limits(NamedTuple):
    """A card's room for a plan (`adain_snake_limits` in the library): its
    SMs, the dynamic shared memory one block of either kernel may take, and
    that of each of two blocks sharing an SM."""
    sms: int
    block: int
    pair: int


class Plan(NamedTuple):
    """How a kernel launch covers (B, C, T): B*C*k blocks in clusters of k,
    one cluster per row; each block takes `slice` elements of its row (a
    multiple of 16 bytes; the kernel puts the boundaries on aligned
    addresses), with `threads` threads and `smem` bytes of dynamic shared
    memory for its slice of x (and, backward, of dy). smem 0: the slice does
    not fit, and each pass streams it from global memory."""
    k: int
    slice: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def _plan(B: int, C: int, T: int, dtype, limits: Limits, backward: bool = False,
          k: Optional[int] = None) -> Plan:
    """The launch plan of K1 (K2 when `backward`) for x (B, C, T) of `dtype`
    on a card with `limits`. k: the smallest cluster size in {1, 2, 4, 8}
    whose B*C*k blocks fill the SMs and whose slices fit two blocks to an SM
    (then one), rows shorter than k * MIN_SLICE not split that far; k = 8
    and streaming where no slice fits. An explicit `k` is taken as it is
    (the tests' ragged edges)."""
    size = 2 if dtype == torch.bfloat16 else 4
    vec = 16 // size
    arrays = 2 if backward else 1

    def at(k):  # (slice, its bytes)
        n = -(-T // k)
        n = -(-n // vec) * vec
        return n, arrays * n * size

    if k is None:
        ks = [k for k in (1, 2, 4, 8) if k == 1 or T >= k * MIN_SLICE]
        fill = next((k for k in ks if B * C * k >= limits.sms), ks[-1])
        k = next((k for limit in (limits.pair, limits.block) for k in ks
                  if k >= fill and at(k)[1] <= limit), 8)
    n, nbytes = at(k)
    threads = 512 if n >= 8192 else 256 if n >= 1024 else 128
    return Plan(k, n, threads, nbytes if nbytes <= limits.block else 0)


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> Limits:
    """The limits of CUDA device `index`, read once."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        err = _load().adain_snake_limits(out)
    if err != 0:
        raise RuntimeError(f"adain_snake: reading the limits of cuda:{index} failed: cudaError {err}")
    return Limits(*out)


def plan_of(x, backward: bool = False, k: Optional[int] = None) -> Plan:
    """The launch plan for the CUDA tensor x (B, C, T) on its card."""
    return _plan(*x.shape, x.dtype, _limits(x.device.index), backward, k)


def _on(x):
    """A context that makes x's card the current one (a no-op when it is):
    the kernels launch on the current device's stream."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _f32(*ts):
    """The per-row operands as contiguous f32, the kernels' layout (the same
    tensors when they are already)."""
    return [t.float().contiguous() for t in ts]


def _check(x, gamma, beta, alpha):
    """Raise on a CUDA input the kernels cannot take; return (B, C, T)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"adain_snake: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"adain_snake: x must be (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adain_snake: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("adain_snake: x must be contiguous and start on a 16-byte boundary "
                         "(a view at another offset: pass a copy)")
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
    return B, C, T


def _forward_kernel(x, gamma, beta, alpha, k: Optional[int] = None):
    """Launch the forward kernel (K1) on CUDA tensors; `k` overrides the
    plan's cluster size."""
    B, C, T = _check(x, gamma, beta, alpha)
    g32, b32, a32 = _f32(gamma, beta, alpha)
    out = torch.empty_like(x)
    plan = plan_of(x, k=k)
    with _on(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _load().adain_snake_forward(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), a32.data_ptr(), out.data_ptr(),
            B, C, T, int(x.dtype == torch.bfloat16), *plan, stream,
        )
    if err != 0:
        raise RuntimeError(f"adain_snake kernel launch failed: cudaError {err} for {plan}")
    adain_snake.launches += 1
    return out


def adain_snake_bwd(x, gamma, beta, alpha, dy, k: Optional[int] = None):
    """Launch the backward kernel (K2) on CUDA tensors: the gradients
    (dx, dgamma, dbeta, dalpha) of `adain_snake` at (x, gamma, beta, alpha)
    for the output cotangent dy, in the primal dtypes. dy must have x's
    shape, dtype and layout. `k` overrides the plan's cluster size."""
    B, C, T = _check(x, gamma, beta, alpha)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"adain_snake_bwd: dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("adain_snake_bwd: dy must be contiguous and start on a 16-byte boundary")
    g32, b32, a32 = _f32(gamma, beta, alpha)
    dx = torch.empty_like(x)
    dgamma, dbeta, dalpha_rows = (torch.empty((B, C), device=x.device) for _ in range(3))
    plan = plan_of(x, True, k)
    with _on(x):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _load().adain_snake_backward(
            x.data_ptr(), dy.data_ptr(), g32.data_ptr(), b32.data_ptr(), a32.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dalpha_rows.data_ptr(),
            B, C, T, int(x.dtype == torch.bfloat16), *plan, stream,
        )
    if err != 0:
        raise RuntimeError(f"adain_snake backward kernel launch failed: cudaError {err} for {plan}")
    adain_snake.bwd_launches += 1
    # dalpha's sum over B, in a fixed order: the same result on every run
    dalpha = dalpha_rows.sum(dim=0)
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dalpha.to(alpha.dtype)


class AdainSnake(torch.autograd.Function):
    """`adain_snake` with its analytic backward. The forward saves only its
    inputs, as the JAX `_fwd` does, and the backward recomputes the
    statistics: K1 / K2 on CUDA tensors, `adain_snake_ref` /
    `adain_snake_bwd_ref` on CPU tensors."""

    @staticmethod
    def forward(ctx, x, gamma, beta, alpha):
        ctx.save_for_backward(x, gamma, beta, alpha)
        if x.device.type == "cpu":
            return adain_snake_ref(x, gamma, beta, alpha)
        return _forward_kernel(x, gamma, beta, alpha)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, alpha = ctx.saved_tensors
        if x.device.type == "cpu":
            return adain_snake_bwd_ref(x, gamma, beta, alpha, dy)
        return adain_snake_bwd(x, gamma, beta, alpha, dy.contiguous())


def adain_snake(x, gamma, beta, alpha):
    """Fused AdaIN + snake of x (B, C, T) f32/bf16 with gamma, beta (B, C)
    and alpha (C,): `AdainSnake` when an input needs a gradient, else the
    forward kernel on CUDA and `adain_snake_ref` on CPU."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, alpha)):
        return AdainSnake.apply(x, gamma, beta, alpha)
    if x.device.type == "cpu":
        return adain_snake_ref(x, gamma, beta, alpha)
    return _forward_kernel(x, gamma, beta, alpha)


adain_snake.launches = 0
adain_snake.bwd_launches = 0


@contextlib.contextmanager
def recorded():
    """Around the capture of a CUDA graph: the forward launches made inside
    are recorded into the graph, not run, so they leave
    `adain_snake.launches` as it was. Yields a one-item list that holds
    their number on exit; the graph's owner adds it back at each replay
    (`replayed`), when the kernels run. The plan and the library must be
    ready before the capture: a warm-up run on the same shapes does that."""
    before = adain_snake.launches
    count = [0]
    try:
        yield count
    finally:
        count[0] = adain_snake.launches - before
        adain_snake.launches = before


def replayed(launches: int) -> None:
    """Count the forward launches of one replay of a captured graph."""
    adain_snake.launches += launches
