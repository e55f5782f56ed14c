"""Style-conditioned 1D residual block (`styletts2_tpu/models/blocks.py`)."""

from __future__ import annotations

import math

import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import (
    AdaIN1d,
    WNConv1d,
    WNConvTranspose1d,
    leaky_relu,
    upsample_nearest_2x,
)


class AdainResBlk1d(nn.Module):
    """AdaIN -> LeakyReLU -> [depthwise ConvTranspose 2x] -> conv3 -> AdaIN ->
    LeakyReLU -> conv3, plus a nearest-2x (+ 1x1) shortcut, scaled 1/sqrt(2).
    NCW in and out. In train mode `dropout` applies before each conv
    (`blocks.py:40,44`); the decoders build it with 0, the prosody
    predictor with 0.2."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int, upsample: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.upsample, self.dropout = upsample, dropout
        self.norm1 = AdaIN1d(style_dim, dim_in)
        self.norm2 = AdaIN1d(style_dim, dim_out)
        self.conv1 = WNConv1d(dim_in, dim_out, 3, padding=1)
        self.conv2 = WNConv1d(dim_out, dim_out, 3, padding=1)
        if upsample:
            self.pool = WNConvTranspose1d(dim_in, dim_in, 3, stride=2, padding=1,
                                          output_padding=1, groups=dim_in)
        if dim_in != dim_out:
            self.conv1x1 = WNConv1d(dim_in, dim_out, 1, bias=False)

    def forward(self, x, s):
        drop = self.dropout if self.training else 0.0
        h = leaky_relu(self.norm1(x, s))
        if self.upsample:
            h = self.pool(h)
        h = self.conv1(F.dropout(h, drop) if drop else h)
        h = leaky_relu(self.norm2(h, s))
        h = self.conv2(F.dropout(h, drop) if drop else h)
        sc = upsample_nearest_2x(x) if self.upsample else x
        if hasattr(self, "conv1x1"):
            sc = self.conv1x1(sc)
        return (h + sc) / math.sqrt(2.0)
