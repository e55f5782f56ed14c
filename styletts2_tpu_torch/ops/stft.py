"""STFT, inverse STFT and the mel front end, torch.stft/istft semantics.

Counterparts of `styletts2_tpu/ops/stft.py`: a centred, reflect-padded
STFT with a Hann window zero-padded to n_fft, an overlap-add inverse
normalised by the summed squared window (the iSTFTNet head), and the
style encoders' normalised log-mel (`preprocess_mel`). The FFTs are
`torch.fft`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; periodic=True matches torch.hann_window."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _padded_window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The Hann window zero-padded to n_fft, made once per device: a CUDA
    graph cannot capture a copy from pageable host memory. Made outside
    inference mode, so that training can save it for its backward."""
    w = np.zeros(n_fft, dtype=np.float32)
    lpad = (n_fft - win_length) // 2
    w[lpad: lpad + win_length] = hann_window(win_length)
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """Complex STFT of (B, T) -> (B, n_fft//2+1, F), center=True, reflect pad."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, n_fft, hop_length)  # (B, F, n_fft)
    frames = frames * _padded_window(n_fft, win_length, x.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def stft_magphase(
    x: torch.Tensor, n_fft: int, hop_length: int, win_length: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|STFT|, angle), each (B, n_fft//2+1, F)."""
    s = stft(x, n_fft, hop_length, win_length)
    return s.abs(), s.angle()


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (B, F, n_fft) -> (B, n_fft + hop*(F-1))."""
    B, nF, n_fft = frames.shape
    return F.fold(
        frames.transpose(1, 2), output_size=(1, n_fft + hop * (nF - 1)),
        kernel_size=(1, n_fft), stride=(1, hop),
    )[:, 0, 0, :]


@functools.lru_cache(maxsize=None)
def _ola_window_sumsq(n_frames: int, n_fft: int, hop: int, win_length: int,
                      device: torch.device) -> torch.Tensor:
    """Overlap-added squared window, with ~0 entries set to 1 (f32), made
    once per shape and device as `_padded_window` is."""
    w2 = _padded_window(n_fft, win_length, torch.device("cpu")).double() ** 2
    acc = overlap_add(w2.expand(1, n_frames, n_fft), hop)[0].float().numpy()
    with torch.inference_mode(False):
        return torch.from_numpy(np.where(acc > 1e-11, acc, 1.0).astype(np.float32)).to(device)


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """Inverse STFT from (|S|, angle), each (B, n_fft//2+1, F) ->
    wave (B, hop*(F-1)), center=True."""
    spec = torch.polar(magnitude, phase)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * _padded_window(n_fft, win_length, frames.device)
    nF = frames.shape[-2]
    y = overlap_add(frames, hop_length)
    y = y / _ola_window_sumsq(nF, n_fft, hop_length, win_length, y.device)
    half = n_fft // 2
    return y[..., half: y.shape[-1] - half]


# ---------------------------------------------------------------------------
# Mel front end and energy (styletts2_tpu/ops/stft.py:52-74, 210-242)
# ---------------------------------------------------------------------------

MEL_MEAN = -4.0
MEL_STD = 4.0
# the reference's torchaudio MelSpectrogram: n_fft 2048, window 1200, hop 300,
# 80 bins of power 2, and a filterbank for torchaudio's default 16 kHz although
# the audio is 24 kHz (its checkpoints were trained on that)
MEL_N_FFT, MEL_WIN, MEL_HOP, N_MELS, MEL_FB_RATE = 2048, 1200, 300, 80, 16000


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int = MEL_FB_RATE) -> np.ndarray:
    """HTK-scale triangular filterbank from 0 Hz to Nyquist without area
    normalisation, (n_freqs, n_mels) f32: torchaudio's
    melscale_fbanks(norm=None, mel_scale='htk')."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz_htk(np.linspace(0.0, _hz_to_mel_htk(sample_rate / 2.0), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def melspectrogram(wave: torch.Tensor, n_fft: int = MEL_N_FFT, win_length: int = MEL_WIN,
                   hop_length: int = MEL_HOP, n_mels: int = N_MELS,
                   fb_sample_rate: int = MEL_FB_RATE) -> torch.Tensor:
    """Power mel spectrogram (B, T) -> (B, n_mels, 1 + T // hop_length). The
    front end's defaults; the training losses' mels take a 24 kHz
    filterbank at their own resolutions."""
    p = stft(wave, n_fft, hop_length, win_length).abs() ** 2  # (B, n_freq, F)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, fb_sample_rate)).to(wave.device)
    return torch.einsum("bft,fm->bmt", p, fb)


def preprocess_mel(wave: torch.Tensor) -> torch.Tensor:
    """Wave (B, T) -> normalised log mel (log(1e-5 + mel) + 4) / 4."""
    return (torch.log(1e-5 + melspectrogram(wave)) - MEL_MEAN) / MEL_STD


def log_norm(x: torch.Tensor, mean: float = MEL_MEAN, std: float = MEL_STD,
             dim: int = -2) -> torch.Tensor:
    """Energy curve of a normalised log mel: the log of the L2 norm over the
    mel bins of the de-normalised linear mel."""
    lin = torch.exp(x * std + mean)
    return torch.log(torch.sqrt(torch.sum(lin * lin, dim=dim)))
