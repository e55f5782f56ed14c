"""GAN discriminators: multi-period and multi-resolution spectrogram
(`styletts2_tpu/models/discriminators.py:25-147`, NCHW), and stage 2's WavLM
discriminator (`:150-166`).

`MultiPeriodDiscriminator` folds the waveform by each period (2, 3, 5, 7,
11) into (B, 1, T/p, p) and runs weight-normed (k, 1) convs;
`MultiResSpecDiscriminator` runs weight-normed (3, 9) convs over |STFT| at
three resolutions, laid out (B, 1, frames, freq). Each returns (real
logits, generated logits, real feature maps, generated feature maps), the
tuple the losses take. `WavLMDiscriminator` scores stacked WavLM hidden
states frame by frame. Module names are the reference checkpoint's
(`styletts2_tpu/convert.py:convert_mpd`, `convert_msd`, `convert_wd`).
Under bf16 training the convolutions compute in their weights' dtype and
the MRSD's STFT in f32 (`torch.fft` takes no bf16).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import WNConv1d, uniform_, weight_norm
from styletts2_tpu_torch.ops.stft import stft


class WNConv2d(nn.Module):
    """Weight-normalised Conv2d: weight_v (out, in, kh, kw), weight_g
    (out, 1, 1, 1) (`layers.weight_norm`)."""

    def __init__(self, cin, cout, kernel_size: Tuple[int, int], stride=(1, 1), padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_v = nn.Parameter(torch.empty(cout, cin, *kernel_size))
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = weight_norm(self.weight_v, self.weight_g)
        return F.conv2d(x.to(w.dtype), w, self.bias, self.stride, self.padding)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        k, pad = kernel_size, (kernel_size - 1) // 2
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            [WNConv2d(chans[i], chans[i + 1], (k, 1), (stride, 1), (pad, 0)) for i in range(4)]
            + [WNConv2d(1024, 1024, (k, 1), (1, 1), (2, 0))]
        )
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, wav):
        """wav (B, T) -> (logits (B, n), feature maps)."""
        B, T = wav.shape
        p = self.period
        if T % p:
            n_pad = p - T % p
            wav = torch.cat([wav, wav[:, -n_pad - 1:-1].flip(1)], dim=1)  # reflect
        x = wav.reshape(B, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class SpecDiscriminator(nn.Module):
    def __init__(self, fft_size: int = 1024, shift_size: int = 120, win_length: int = 600):
        super().__init__()
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length
        specs = [((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                 ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1))]
        self.discriminators = nn.ModuleList(
            WNConv2d(1 if i == 0 else 32, 32, k, s, p) for i, (k, s, p) in enumerate(specs))
        self.out = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, wav):
        mag = stft(wav.float(), self.fft_size, self.shift_size, self.win_length).abs()
        x = mag.transpose(-1, -2)[:, None]  # (B, 1, frames, freq)
        fmap = []
        for conv in self.discriminators:
            x = F.leaky_relu(conv(x), 0.1)
            fmap.append(x)
        x = self.out(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _pairs(discs, y, y_hat):
    rs, gs, fr, fg = [], [], [], []
    for d in discs:
        out_r, fmap_r = d(y)
        out_g, fmap_g = d(y_hat)
        rs.append(out_r)
        gs.append(out_g)
        fr.append(fmap_r)
        fg.append(fmap_g)
    return rs, gs, fr, fg


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y, y_hat):
        return _pairs(self.discriminators, y, y_hat)


class MultiResSpecDiscriminator(nn.Module):
    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            SpecDiscriminator(f, h, w) for f, h, w in zip(fft_sizes, hop_sizes, win_lengths))

    def forward(self, y, y_hat):
        return _pairs(self.discriminators, y, y_hat)


class WavLMDiscriminator(nn.Module):
    """The SLM discriminator: stacked WavLM states (B, T, slm_hidden *
    slm_layers) -> logits (B, T). A weight-normed 1x1 `pre` conv to
    initial_channel, three weight-normed k = 5 convs (x2, x4, x4 channels)
    each followed by LeakyReLU(0.1), and a k = 3 `conv_post` to one channel."""

    def __init__(self, slm_hidden: int = 768, slm_layers: int = 13, initial_channel: int = 64):
        super().__init__()
        c = initial_channel
        self.pre = WNConv1d(slm_hidden * slm_layers, c, 1)
        self.convs = nn.ModuleList([WNConv1d(c, c * 2, 5, padding=2),
                                    WNConv1d(c * 2, c * 4, 5, padding=2),
                                    WNConv1d(c * 4, c * 4, 5, padding=2)])
        self.conv_post = WNConv1d(c * 4, 1, 3, padding=1)

    def forward(self, x):
        x = self.pre(x.transpose(1, 2))
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.1)
        return self.conv_post(x).flatten(1)


@torch.no_grad()
def init_discriminator_(m: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's WNConv2d init: v and bias U(+-1/sqrt(fan_in)), g = 1."""
    for mod in m.modules():
        if isinstance(mod, WNConv2d):
            bound = 1.0 / math.sqrt(mod.weight_v[0].numel())
            uniform_(mod.weight_v, bound, generator)
            mod.weight_g.fill_(1.0)
            uniform_(mod.bias, bound, generator)
