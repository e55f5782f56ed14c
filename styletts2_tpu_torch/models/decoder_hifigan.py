"""HiFi-GAN decoder with the harmonic-plus-noise NSF source, inference only
(`styletts2_tpu/models/decoder_hifigan.py`).

The AdaIN head is the iSTFTNet decoder's; the Generator differs: a snake
pre-activation per stage (`generator.alphas.{i}`), four transposed-conv
upsamplings (rates 10, 5, 3, 2 for LibriTTS; padding u//2 + u%2,
output_padding u%2), the raw one-channel harmonic source injected at every
stage through a strided conv, and a final snake, conv_post (C -> 1, k = 7)
and tanh in f32 (under bf16 too: its weights upcast). NCW activations in
asr's dtype, the source joining it. Every `AdaINResBlock1` (one `noise_res`
and three `resblocks` per stage) runs the fused `adain_snake` kernel twice
per dilation: 16 blocks x 3 dilations x 2 = 96 launches per decode (192
per differentiated decode under `remat`, as the iSTFTNet Generator's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.decoder_istft import (
    AdaINResBlock1,
    DecoderHead,
    SourceModuleHnNSF,
    rematerialized,
    upsample_nearest,
)
from styletts2_tpu_torch.models.layers import WNConv1d, WNConvTranspose1d, snake


class Generator(nn.Module):
    def __init__(self, style_dim: int = 128, resblock_kernel_sizes=(3, 7, 11),
                 upsample_rates=(10, 5, 3, 2), upsample_initial_channel: int = 512,
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_kernel_sizes=(20, 10, 6, 4), remat: bool = False):
        super().__init__()
        self.remat = remat
        self.num_kernels = len(resblock_kernel_sizes)
        self.total_up = int(np.prod(upsample_rates))
        self.m_source = SourceModuleHnNSF(upsample_scale=self.total_up, harmonic_num=8)
        n_up = len(upsample_rates)
        self.alphas = nn.ParameterList(
            nn.Parameter(torch.ones(1, upsample_initial_channel // 2 ** i, 1))
            for i in range(n_up + 1))
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_prev = upsample_initial_channel // 2 ** i
            c_cur = upsample_initial_channel // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(c_prev, c_cur, k, stride=u, padding=u // 2 + u % 2,
                                              output_padding=u % 2))
            if i + 1 < n_up:
                stride_f0 = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(nn.Conv1d(1, c_cur, stride_f0 * 2, stride=stride_f0,
                                                  padding=(stride_f0 + 1) // 2))
                self.noise_res.append(AdaINResBlock1(c_cur, 7, (1, 3, 5), style_dim))
            else:
                self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
                self.noise_res.append(AdaINResBlock1(c_cur, 11, (1, 3, 5), style_dim))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AdaINResBlock1(c_cur, rk, tuple(rd), style_dim))
        self.conv_post = WNConv1d(c_cur, 1, 7, padding=3)

    def forward(self, x, s, f0_curve, generator: Optional[torch.Generator] = None,
                har_source=None):
        """x (B, C0, T_mel), s (B, style), f0_curve (B, T_mel) -> wav
        (B, T_mel * prod(upsample_rates)). The source is drawn here unless
        `har_source` is given."""
        if har_source is None:
            f0 = upsample_nearest(f0_curve, self.total_up)[..., None]
            # (B, L, 1) -> (B, 1, L) with NCW strides: the transposed view's strides
            # read as channels-last, and cuDNN would then return the noise convs'
            # outputs channels-last, which the fused kernel does not take
            har_source = self.m_source(f0, generator)[0].reshape(f0.shape[0], 1, -1).detach()
            har_source = har_source.to(x.dtype)
            if self.remat and torch.is_grad_enabled():
                return rematerialized(self, (x, s, f0_curve), {"har_source": har_source})
        for i, up in enumerate(self.ups):
            x = snake(x, self.alphas[i])
            xs_src = self.noise_res[i](self.noise_convs[i](har_source), s)
            x = up(x) + xs_src
            acc = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x, s)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        x = snake(x, self.alphas[-1]).float()
        post = self.conv_post
        y = F.conv1d(x, post.weight.float(), post.bias.float(), padding=post.padding)
        return torch.tanh(y)[:, 0]


class Decoder(DecoderHead):
    """The AdaIN head driving the HiFi-GAN Generator: wav
    (B, T_en * 2 * prod(upsample_rates))."""

    def __init__(self, dim_in: int = 512, style_dim: int = 128, resblock_kernel_sizes=(3, 7, 11),
                 upsample_rates=(10, 5, 3, 2), upsample_initial_channel: int = 512,
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_kernel_sizes=(20, 10, 6, 4), bottleneck: int = 1024,
                 remat: bool = False):
        super().__init__(dim_in, style_dim, upsample_initial_channel, bottleneck)
        self.generator = Generator(style_dim, resblock_kernel_sizes, upsample_rates,
                                   upsample_initial_channel, resblock_dilation_sizes,
                                   upsample_kernel_sizes, remat)
