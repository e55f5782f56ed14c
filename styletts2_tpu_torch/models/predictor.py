"""Prosody predictor: durations, F0 and energy (`styletts2_tpu/models/predictor.py`)."""

from __future__ import annotations

import torch
from torch import nn

from styletts2_tpu_torch.models.blocks import AdainResBlk1d
from styletts2_tpu_torch.models.layers import AdaLayerNorm, BiLSTM


class DurationEncoder(nn.Module):
    """nlayers x [BiLSTM -> AdaLayerNorm(style) -> re-concat style], masked.
    `lstms` alternates the two kinds, as the reference checkpoint does."""

    def __init__(self, sty_dim: int = 128, d_model: int = 512, nlayers: int = 3):
        super().__init__()
        self.sty_dim = sty_dim
        layers = []
        for _ in range(nlayers):
            layers += [BiLSTM(d_model + sty_dim, d_model // 2), AdaLayerNorm(sty_dim, d_model)]
        self.lstms = nn.ModuleList(layers)

    def forward(self, x, style, lengths):
        """x (B, T, d_model), style (B, sty_dim) -> (B, T, d_model + sty_dim)."""
        B, T, _ = x.shape
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])[..., None]
        s_seq = style[:, None, :].expand(B, T, self.sty_dim)
        x = torch.cat([x, s_seq], dim=-1).masked_fill(~valid, 0.0)
        for lstm, ada in zip(self.lstms[0::2], self.lstms[1::2]):
            h = ada(lstm(x, lengths), style)
            x = torch.cat([h, s_seq], dim=-1).masked_fill(~valid, 0.0)
        return x


class LinearNorm(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim)

    def forward(self, x):
        return self.linear_layer(x)


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim: int = 128, d_hid: int = 512, nlayers: int = 3,
                 max_dur: int = 50):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = LinearNorm(d_hid, max_dur)
        self.shared = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.F0 = self._branch(d_hid, style_dim)
        self.N = self._branch(d_hid, style_dim)
        self.F0_proj = nn.Conv1d(d_hid // 2, 1, 1)
        self.N_proj = nn.Conv1d(d_hid // 2, 1, 1)

    @staticmethod
    def _branch(d_hid, style_dim):
        return nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim),
        ])

    def encode_texts(self, texts, style, lengths):
        """(B, T, d_hid) -> (B, T, d_hid + style_dim)."""
        return self.text_encoder(texts, style, lengths)

    def duration(self, d, lengths):
        """Duration logits (B, T, max_dur) from encoded texts d (B, T, C)."""
        return self.duration_proj(self.lstm(d, lengths))

    def F0Ntrain(self, x, s):
        """x (B, d_hid + style_dim, F) aligned features -> F0, N, each (B, 2F)."""
        h = self.shared(x.transpose(1, 2)).transpose(1, 2)
        f, n = h, h
        for blk in self.F0:
            f = blk(f, s)
        for blk in self.N:
            n = blk(n, s)
        return self.F0_proj(f)[:, 0], self.N_proj(n)[:, 0]
