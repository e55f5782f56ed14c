"""iSTFTNet decoder with the harmonic-plus-noise NSF source
(`styletts2_tpu/models/decoder_istft.py`).

NCW activations in the dtype of the text features `asr` and the weights:
f32, or bf16 for the bf16 decoder and bf16 training. Every `AdaINResBlock1`
runs its instance norm, style affine and snake through the fused
`adain_snake` kernel: two calls per dilation, so a Generator with 8 such
blocks of 3 dilations launches it 48 times forward, and its backward kernel
as often in training. The NSF source (no gradient, as in the JAX package)
draws its initial phase and its additive noise, and the train-mode F0/N box
smoothing its kernel widths, from the `torch.Generator` the caller passes.
Under bf16 these stay f32 (`styletts2_tpu/models/decoder_istft.py`): the
pitch the source reads, its sines (their phase reaches thousands of
radians) and merge, the source's STFT, and the head: conv_post, exp / sin
and the iSTFT; the waveform comes back f32.

With `remat` (the config's `remat_decoder`) a Generator run that records a
graph keeps only its inputs: its body is recomputed in the backward
(`rematerialized`), so each of its K1 launches runs twice and K2 as often
as before. The NSF source is drawn before the checkpoint and handed to the
body, so that the recompute reads the same sines and noise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from styletts2_tpu_torch.models.blocks import AdainResBlk1d
from styletts2_tpu_torch.models.layers import StyleAffine, WNConv1d, WNConvTranspose1d, leaky_relu
from styletts2_tpu_torch.ops.adain_snake import adain_snake
from styletts2_tpu_torch.ops.stft import istft, stft_magphase


def interp_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation over time of (B, T, C), align_corners=False."""
    T = x.shape[1]
    scale = out_len / T
    coords = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) / scale - 0.5
    coords = coords.clamp(0.0, T - 1.0)
    lo = coords.floor().to(torch.int64)
    hi = (lo + 1).clamp(max=T - 1)
    w = (coords - lo)[None, :, None]
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


def rematerialized(module: nn.Module, args, kwargs):
    """module(*args, **kwargs) under activation checkpointing: the backward
    recomputes it with the parameters and buffers this call read (under
    mixed precision the step's bf16 copies, which `train/mp.py:run` swaps in
    only for the call's duration)."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    return checkpoint(lambda *a: functional_call(module, tensors, a, kwargs), *args,
                      use_reentrant=False)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of the last (time) axis by an integer factor."""
    return torch.repeat_interleave(x, factor, dim=-1)


class SineGen(nn.Module):
    """Harmonic sine source; no parameters."""

    def __init__(self, samp_rate: int = 24000, upsample_scale: int = 300,
                 harmonic_num: int = 8, sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 10.0):
        super().__init__()
        self.samp_rate, self.upsample_scale = samp_rate, upsample_scale
        self.dim = harmonic_num + 1
        self.sine_amp, self.noise_std = sine_amp, noise_std
        self.voiced_threshold = voiced_threshold

    def forward(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None):
        """f0 (B, L, 1) at sample rate -> (sine_waves (B, L, dim), uv (B, L, 1)),
        f32 whatever f0's dtype."""
        f0 = f0.float()
        B, L, _ = f0.shape
        harmonics = torch.arange(1, self.dim + 1, device=f0.device, dtype=torch.float32)
        rad = torch.remainder(f0 * harmonics / self.samp_rate, 1.0)
        rand_ini = torch.rand((B, self.dim), generator=generator, device=f0.device)
        rand_ini[:, 0] = 0.0
        rad[:, 0, :] += rand_ini
        # phase accumulated at frame rate, then upsampled
        rad_frame = interp_linear(rad, L // self.upsample_scale)
        phase_frame = torch.cumsum(rad_frame, dim=1) * 2.0 * np.pi
        sines = torch.sin(interp_linear(phase_frame * self.upsample_scale, L))
        uv = (f0 > self.voiced_threshold).float()
        noise_amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
        noise = noise_amp * torch.randn(sines.shape, generator=generator, device=f0.device)
        return sines * self.sine_amp * uv + noise, uv


class SourceModuleHnNSF(nn.Module):
    """Merge the harmonics into one excitation: tanh(Linear(sines)), in f32
    (bf16 weights upcast)."""

    def __init__(self, upsample_scale: int = 300, harmonic_num: int = 8):
        super().__init__()
        self.l_sin_gen = SineGen(upsample_scale=upsample_scale, harmonic_num=harmonic_num)
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0, generator=None):
        sine_wavs, uv = self.l_sin_gen(f0, generator)
        lin = self.l_linear
        return torch.tanh(F.linear(sine_wavs, lin.weight.float(), lin.bias.float())), uv


class AdaINResBlock1(nn.Module):
    """Snake-activated AdaIN residual block; the norm + affine + snake chain
    is the fused `adain_snake` kernel."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), style_dim: int = 64):
        super().__init__()
        C, k = channels, kernel_size
        self.convs1 = nn.ModuleList(
            WNConv1d(C, C, k, padding=(k - 1) * d // 2, dilation=d) for d in dilations)
        self.convs2 = nn.ModuleList(
            WNConv1d(C, C, k, padding=(k - 1) // 2) for _ in dilations)
        self.adain1 = nn.ModuleList(StyleAffine(style_dim, C) for _ in dilations)
        self.adain2 = nn.ModuleList(StyleAffine(style_dim, C) for _ in dilations)
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(1, C, 1)) for _ in dilations)
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(1, C, 1)) for _ in dilations)

    def forward(self, x, s):
        for c1, c2, n1, n2, a1, a2 in zip(self.convs1, self.convs2, self.adain1,
                                          self.adain2, self.alpha1, self.alpha2):
            h = c1(adain_snake(x, *n1(s), a1.reshape(-1)))
            h = c2(adain_snake(h, *n2(s), a2.reshape(-1)))
            x = x + h
        return x


class Generator(nn.Module):
    """NSF source + transposed-conv upsampling + AdaIN resblocks + iSTFT head."""

    def __init__(self, style_dim: int = 128, resblock_kernel_sizes=(3, 7, 11),
                 upsample_rates=(10, 6), upsample_initial_channel: int = 512,
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_kernel_sizes=(20, 12), gen_istft_n_fft: int = 20,
                 gen_istft_hop_size: int = 5, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.num_kernels = len(resblock_kernel_sizes)
        self.n_fft, self.hop = gen_istft_n_fft, gen_istft_hop_size
        self.total_up = int(np.prod(upsample_rates)) * gen_istft_hop_size
        self.m_source = SourceModuleHnNSF(upsample_scale=self.total_up, harmonic_num=8)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        n_src = gen_istft_n_fft + 2
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_prev = upsample_initial_channel // (2 ** i)
            c_cur = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(c_prev, c_cur, k, stride=u, padding=(k - u) // 2,
                                              output_padding=0))
            if i + 1 < len(upsample_rates):
                stride_f0 = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(nn.Conv1d(n_src, c_cur, stride_f0 * 2, stride=stride_f0,
                                                  padding=(stride_f0 + 1) // 2))
                self.noise_res.append(AdaINResBlock1(c_cur, 7, (1, 3, 5), style_dim))
            else:
                self.noise_convs.append(nn.Conv1d(n_src, c_cur, 1))
                self.noise_res.append(AdaINResBlock1(c_cur, 11, (1, 3, 5), style_dim))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(c_cur, rk, tuple(rd), style_dim))
        self.conv_post = WNConv1d(c_cur, n_src, 7, padding=3)

    def forward(self, x, s, f0_curve, generator=None, har=None):
        """x (B, C0, T_mel), s (B, style), f0_curve (B, T_mel) -> wav (B,
        T_mel * 300). `har`, the source's STFT, is drawn here unless given."""
        if har is None:
            f0 = upsample_nearest(f0_curve, self.total_up)[..., None]
            har_source = self.m_source(f0, generator)[0][..., 0].detach()
            har = torch.cat(stft_magphase(har_source, self.n_fft, self.hop, self.n_fft),
                            dim=1).to(x.dtype)
            if self.remat and torch.is_grad_enabled():
                return rematerialized(self, (x, s, f0_curve), {"har": har})
        n_up = len(self.ups)
        for i in range(n_up):
            x = leaky_relu(x, 0.1)
            xs_src = self.noise_res[i](self.noise_convs[i](har), s)
            x = self.ups[i](x)
            if i == n_up - 1:
                x = torch.cat([x[:, :, 1:2], x], dim=-1)  # reflection pad (1, 0)
            x = x + xs_src
            acc = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x, s)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        # the head in f32, conv_post included (its weights upcast): its phase
        # channels reach |x| ~ 10-20, where a bf16 output would round the
        # phase to 0.06-0.125 rad
        post = self.conv_post
        x = F.conv1d(leaky_relu(x).float(), post.weight.float(), post.bias.float(),
                     padding=post.padding)
        n_half = self.n_fft // 2 + 1
        return istft(torch.exp(x[:, :n_half]), torch.sin(x[:, n_half:]),
                     self.n_fft, self.hop, self.n_fft)


def box_smooth(x: torch.Tensor, k: int) -> torch.Tensor:
    """Box filter of width k over (B, T), zero padding k // 2 (JAX `_box_smooth`)."""
    w = torch.full((1, 1, k), 1.0 / k, device=x.device, dtype=x.dtype)
    return F.conv1d(x[:, None], w, padding=k // 2)[:, 0]


F0_SMOOTH_WIDTHS = (0, 3, 7)  # train-mode choices; 0 leaves the curve as it is
N_SMOOTH_WIDTHS = (0, 3, 7, 15)


def random_box_smooth(x: torch.Tensor, widths, generator: Optional[torch.Generator] = None):
    """`box_smooth` of x with a width drawn uniformly from `widths` by `generator`."""
    dev = generator.device if generator is not None else x.device
    k = widths[int(torch.randint(0, len(widths), (), generator=generator, device=dev))]
    return box_smooth(x, k) if k else x


class DecoderHead(nn.Module):
    """The AdaIN encode/decode head that drives a Generator, shared by the
    iSTFTNet and HiFi-GAN decoders; a subclass sets `self.generator`.

    asr (B, dim_in, T_en) text features; F0_curve, N (B, 2*T_en); s (B,
    style_dim) -> the generator's waveform. In train mode the F0 and N
    curves are first box-smoothed, each with a width drawn uniformly from
    F0_SMOOTH_WIDTHS / N_SMOOTH_WIDTHS (`decoder_istft.py:276-296`). The
    curves' convolutions run in asr's dtype; the generator's source reads
    the F0 curve in f32."""

    def __init__(self, dim_in: int, style_dim: int, upsample_initial_channel: int,
                 bottleneck: int = 1024):
        super().__init__()
        bn = bottleneck
        self.F0_conv = WNConv1d(1, 1, 3, stride=2, padding=1)
        self.N_conv = WNConv1d(1, 1, 3, stride=2, padding=1)
        self.encode = AdainResBlk1d(dim_in + 2, bn, style_dim)
        self.asr_res = nn.Sequential(WNConv1d(dim_in, 64, 1))
        self.decode = nn.ModuleList([
            AdainResBlk1d(bn + 2 + 64, bn, style_dim),
            AdainResBlk1d(bn + 2 + 64, bn, style_dim),
            AdainResBlk1d(bn + 2 + 64, bn, style_dim),
            AdainResBlk1d(bn + 2 + 64, upsample_initial_channel, style_dim, upsample=True),
        ])

    def forward(self, asr, f0_curve, n_curve, s, generator: Optional[torch.Generator] = None):
        if self.training:
            f0_curve = random_box_smooth(f0_curve, F0_SMOOTH_WIDTHS, generator)
            n_curve = random_box_smooth(n_curve, N_SMOOTH_WIDTHS, generator)
        F0 = self.F0_conv(f0_curve.to(asr.dtype)[:, None])
        N = self.N_conv(n_curve.to(asr.dtype)[:, None])
        x = self.encode(torch.cat([asr, F0, N], dim=1), s)
        asr_res = self.asr_res(asr)
        for blk in self.decode:
            x = blk(torch.cat([x, asr_res, F0, N], dim=1), s)
        return self.generator(x, s, f0_curve.float(), generator)


class Decoder(DecoderHead):
    """The AdaIN head driving the iSTFTNet Generator: wav (B, T_en * 600)."""

    def __init__(self, dim_in: int = 512, style_dim: int = 128, resblock_kernel_sizes=(3, 7, 11),
                 upsample_rates=(10, 6), upsample_initial_channel: int = 512,
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_kernel_sizes=(20, 12), gen_istft_n_fft: int = 20,
                 gen_istft_hop_size: int = 5, bottleneck: int = 1024, remat: bool = False):
        super().__init__(dim_in, style_dim, upsample_initial_channel, bottleneck)
        self.generator = Generator(style_dim, resblock_kernel_sizes, upsample_rates,
                                   upsample_initial_channel, resblock_dilation_sizes,
                                   upsample_kernel_sizes, gen_istft_n_fft, gen_istft_hop_size,
                                   remat)
