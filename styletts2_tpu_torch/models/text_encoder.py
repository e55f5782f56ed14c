"""Phoneme text encoder (`styletts2_tpu/models/text_encoder.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import BiLSTM, ChannelLayerNorm, WNConv1d, leaky_relu


class TextEncoder(nn.Module):
    """Embedding + depth x (WN conv k5, channel LayerNorm, LeakyReLU 0.2,
    dropout in train mode) + BiLSTM, zeroed at padded positions throughout."""

    def __init__(self, channels: int = 512, kernel_size: int = 5, depth: int = 3,
                 n_symbols: int = 178, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.embedding = nn.Embedding(n_symbols, channels)
        pad = (kernel_size - 1) // 2
        self.cnn = nn.ModuleList(
            nn.ModuleList([WNConv1d(channels, channels, kernel_size, padding=pad),
                           ChannelLayerNorm(channels)])
            for _ in range(depth)
        )
        self.lstm = BiLSTM(channels, channels // 2)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) int, lengths (B,) -> (B, channels, T)."""
        T = tokens.shape[1]
        valid = (torch.arange(T, device=tokens.device)[None, :]
                 < lengths.to(tokens.device)[:, None])[:, None, :]
        x = self.embedding(tokens).transpose(1, 2)
        x = x.masked_fill(~valid, 0.0)
        for conv, norm in self.cnn:
            x = F.dropout(leaky_relu(norm(conv(x))), self.dropout, self.training)
            x = x.masked_fill(~valid, 0.0)
        x = self.lstm(x.transpose(1, 2), lengths).transpose(1, 2)
        return x.masked_fill(~valid, 0.0)
