"""Mel-reference style encoder (`styletts2_tpu/models/style_encoder.py`).

A spectral-norm Conv2d stem, `repeat_num` SN residual blocks that halve
both mel axes, LeakyReLU(0.2), a 5x5 valid conv, a global average pool and
a Linear to style_dim. The mel (B, n_mels, T) is a one-channel NCHW image.
Module names follow the reference checkpoint: `shared.{0, 1..repeat_num,
repeat_num + 2}` and `unshared` (`styletts2_tpu/convert.py:convert_style_encoder`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from styletts2_tpu_torch.models.layers import SNConv2d, avg_pool_2d_2x, leaky_relu


class LearnedDownSample(nn.Module):
    """Depthwise stride-2 SN conv: the residual path's 'half' downsample."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = SNConv2d(channels, channels, 3, stride=2, padding=1, groups=channels)

    def forward(self, x, update_stats: bool = False):
        return self.conv(x, update_stats)


class ResBlk2d(nn.Module):
    """LeakyReLU -> conv3 -> learned 2x downsample -> LeakyReLU -> conv3, plus
    a (1x1 conv) 2x2 average-pool shortcut, scaled 1/sqrt(2)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv1 = SNConv2d(dim_in, dim_in, 3, padding=1)
        self.downsample_res = LearnedDownSample(dim_in)
        self.conv2 = SNConv2d(dim_in, dim_out, 3, padding=1)
        if dim_in != dim_out:
            self.conv1x1 = SNConv2d(dim_in, dim_out, 1, bias=False)

    def forward(self, x, update_stats: bool = False):
        h = self.conv1(leaky_relu(x), update_stats)
        h = self.conv2(leaky_relu(self.downsample_res(h, update_stats)), update_stats)
        s = self.conv1x1(x, update_stats) if hasattr(self, "conv1x1") else x
        return (avg_pool_2d_2x(s) + h) / math.sqrt(2.0)


class StyleEncoder(nn.Module):
    """mel (B, n_mels, T) -> style (B, style_dim)."""

    def __init__(self, dim_in: int = 64, style_dim: int = 128, max_conv_dim: int = 512,
                 repeat_num: int = 4):
        super().__init__()
        self.repeat_num = repeat_num
        layers = [SNConv2d(1, dim_in, 3, padding=1)]
        d = dim_in
        for _ in range(repeat_num):
            d_out = min(d * 2, max_conv_dim)
            layers.append(ResBlk2d(d, d_out))
            d = d_out
        layers += [nn.LeakyReLU(0.2), SNConv2d(d, d, 5)]
        self.shared = nn.ModuleList(layers)
        self.unshared = nn.Linear(d, style_dim)

    def forward(self, mel: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                update_stats: bool = False):
        """With `lengths` (B,) of valid mel frames, frames past them are
        zeroed and the pool averages only the valid width, so a padded batch
        gives each item its own style."""
        min_frames = 5 * 2 ** self.repeat_num  # stride-2 stages + the 5-wide conv
        T = mel.shape[-1]
        if T < min_frames:
            raise ValueError(f"StyleEncoder(repeat_num={self.repeat_num}) needs "
                             f">={min_frames} mel frames, got {T}")
        if lengths is not None:
            lengths = lengths.to(mel.device)
            mel = mel.masked_fill(torch.arange(T, device=mel.device)[None, None, :]
                                  >= lengths[:, None, None], 0.0)
        x = mel[:, None]
        for layer in self.shared:
            x = layer(x) if isinstance(layer, nn.LeakyReLU) else layer(x, update_stats)
        if lengths is None:
            x = x.mean(dim=(2, 3))
        else:
            lv = lengths
            for _ in range(self.repeat_num):
                lv = (lv + 1) // 2
            lv = torch.clamp(lv - 4, min=1)
            W = x.shape[-1]
            wmask = (torch.arange(W, device=x.device)[None, :] < lv[:, None]).to(x.dtype)
            x = (x * wmask[:, None, None, :]).sum(dim=(2, 3)) / (x.shape[2] * lv[:, None])
        return self.unshared(leaky_relu(x))
