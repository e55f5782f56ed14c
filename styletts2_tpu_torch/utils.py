"""Alignment expansion from integer durations, WAV reading and writing and
resampling (numpy, `styletts2_tpu/utils.py`), and the entry points'
precision setting."""

from __future__ import annotations

import math
import wave as _wave
from typing import Tuple

import numpy as np
import torch


def set_f32_compute() -> None:
    """Run convolutions and matmuls in full f32: turn TF32 off in cuDNN and
    in cuBLAS (torch's default leaves it on for cuDNN). The entry points
    call it, so that what ships runs at the precision the CPU parity tests
    and the card's checks hold; bf16 is asked for explicitly (the
    synthesizer's `decoder_dtype`, the config's `mixed_precision`)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def duration_to_alignment(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Integer durations (B, N) -> hard one-hot alignment (B, N, n_frames) f32:
    frame t belongs to token i iff cumsum[i-1] <= t < cumsum[i]."""
    cs = torch.cumsum(durations, dim=-1)
    starts = cs - durations
    t = torch.arange(n_frames, device=durations.device)[None, None, :]
    return ((t >= starts[..., None]) & (t < cs[..., None])).to(torch.float32)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM WAV -> (float32 samples in [-1, 1], sample rate); the first
    channel of a multichannel file."""
    with _wave.open(path, "rb") as f:
        sr, n, ch, sw = f.getframerate(), f.getnframes(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]
    return data, sr


def write_wav(path, data: np.ndarray, sr: int) -> None:
    """Float32 [-1, 1] mono audio -> a 16-bit PCM WAV at `path` (a file name
    or a binary file object)."""
    pcm = (np.clip(np.asarray(data, dtype=np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    with _wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear interpolation to round(len(x) * sr_out / sr_in) samples: the
    demo's cheap resampler for a reference voice (the data path and the
    server use `resample_sinc`)."""
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t = np.linspace(0.0, len(x) - 1.0, n_out)
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)


def resample_sinc(x: np.ndarray, sr_in: int, sr_out: int, zeros: int = 24,
                  beta: float = 8.555) -> np.ndarray:
    """Rational polyphase resampler with a Kaiser-windowed sinc low-pass at
    the lower Nyquist, `zeros` lobes per side (the design of
    scipy.signal.resample_poly). Output length ceil(len(x) * sr_out / sr_in)."""
    x = np.asarray(x, dtype=np.float32)
    if sr_in == sr_out:
        return x
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = int(sr_out) // g, int(sr_in) // g
    max_rate = max(up, down)
    half = zeros * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    f_c = 1.0 / (2.0 * max_rate)  # cut-off in cycles per sample at the upsampled rate
    h = (2.0 * f_c * up) * np.sinc(2.0 * f_c * n) * np.kaiser(2 * half + 1, beta)
    n_out = -(-len(x) * up // down)
    taps = 2 * half // up + 1  # input samples under the filter
    # output j reads the inputs up to kmax_j = (j*down + half) // up with the
    # filter phase r_j = (j*down + half) % up; outputs j, j + up, ... share a
    # phase and step kmax by `down`, so each phase is one strided matvec
    hp = np.zeros(taps * up, dtype=np.float64)
    hp[: 2 * half + 1] = h
    H = hp.reshape(taps, up).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(np.pad(x, (taps, taps)), taps)
    out = np.empty(n_out, dtype=np.float32)
    for j0 in range(min(up, n_out)):
        kmax, r = divmod(j0 * down + half, up)
        js = np.arange(j0, n_out, up)
        q = kmax + (js - j0) // up * down
        out[js] = win[q + 1] @ H[::-1, r]
    return out
