"""Prosody predictor: durations, F0 and energy (`styletts2_tpu/models/predictor.py`).

In train mode three dropouts apply, as in the JAX package: `dropout` (0.2)
after each LSTM of the duration encoder, 0.5 before the duration
projection, and `dropout` before each conv of the F0 / N blocks. They draw
from torch's global generator; eval mode is deterministic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.blocks import AdainResBlk1d
from styletts2_tpu_torch.models.layers import AdaLayerNorm, BiLSTM


class DurationEncoder(nn.Module):
    """nlayers x [BiLSTM -> AdaLayerNorm(style) -> re-concat style], masked.
    `lstms` alternates the two kinds, as the reference checkpoint does."""

    def __init__(self, sty_dim: int = 128, d_model: int = 512, nlayers: int = 3,
                 dropout: float = 0.2):
        super().__init__()
        self.sty_dim, self.dropout = sty_dim, dropout
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
            h = ada(F.dropout(lstm(x, lengths), self.dropout, self.training), style)
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
                 max_dur: int = 50, dropout: float = 0.2):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers, dropout)
        self.lstm = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.duration_proj = LinearNorm(d_hid, max_dur)
        self.shared = BiLSTM(d_hid + style_dim, d_hid // 2)
        self.F0 = self._branch(d_hid, style_dim, dropout)
        self.N = self._branch(d_hid, style_dim, dropout)
        self.F0_proj = nn.Conv1d(d_hid // 2, 1, 1)
        self.N_proj = nn.Conv1d(d_hid // 2, 1, 1)

    @staticmethod
    def _branch(d_hid, style_dim, dropout):
        return nn.ModuleList([
            AdainResBlk1d(d_hid, d_hid, style_dim, dropout=dropout),
            AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True, dropout=dropout),
            AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim, dropout=dropout),
        ])

    def encode_texts(self, texts, style, lengths):
        """(B, T, d_hid) -> (B, T, d_hid + style_dim)."""
        return self.text_encoder(texts, style, lengths)

    def duration(self, d, lengths):
        """Duration logits (B, T, max_dur) from encoded texts d (B, T, C)."""
        return self.duration_proj(F.dropout(self.lstm(d, lengths), 0.5, self.training))

    def forward(self, texts, style, lengths, alignment):
        """texts (B, T, d_hid), alignment (B, T, F) -> (duration logits
        (B, T, max_dur), the aligned features (B, d_hid + style_dim, F))."""
        d = self.encode_texts(texts, style, lengths)
        return self.duration(d, lengths), d.transpose(1, 2) @ alignment

    def F0Ntrain(self, x, s):
        """x (B, d_hid + style_dim, F) aligned features -> F0, N, each (B, 2F)."""
        h = self.shared(x.transpose(1, 2)).transpose(1, 2)
        f, n = h, h
        for blk in self.F0:
            f = blk(f, s)
        for blk in self.N:
            n = blk(n, s)
        return self.F0_proj(f)[:, 0], self.N_proj(n)[:, 0]
