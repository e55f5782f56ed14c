"""Single-speaker style denoiser, Transformer1d
(`styletts2_tpu/models/diffusion/denoiser.py`, style_cond=False).

The (B, 1, channels) noisy style is broadcast along the PL-BERT sequence,
concatenated with it, run through pre-LN transformer blocks with a
time-mapping vector added before each, mean-pooled over the valid positions
and projected back. Padded keys are masked out of the attention with
finfo.min, and classifier-free guidance runs cond and uncond as one batched
pass. Attention is plain tensor ops. Module names follow the reference
checkpoint (`styletts2_tpu/convert.py:convert_diffusion`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# flax.linen.LayerNorm's default epsilon, which the JAX denoiser uses
_LN_EPS = 1e-6


class _SwapLast(nn.Module):
    def forward(self, x):
        return x.transpose(1, 2)


class LearnedPositionalEmbedding(nn.Module):
    """Continuous-time Fourier features [t, sin(2 pi t w), cos(2 pi t w)]."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t):
        freqs = t[:, None] * self.weights[None, :] * 2.0 * math.pi
        return torch.cat([t[:, None], freqs.sin(), freqs.cos()], dim=-1)


class FixedEmbedding(nn.Module):
    def __init__(self, max_length: int, features: int):
        super().__init__()
        self.embedding = nn.Embedding(max_length, features)


class AttentionOut(nn.Module):
    def __init__(self, mid: int, features: int):
        super().__init__()
        self.to_out = nn.Linear(mid, features)


class SelfAttention(nn.Module):
    """Pre-LN self-attention with separate norms for the query and key/value
    inputs, as the reference has."""

    def __init__(self, features: int, num_heads: int, head_features: int):
        super().__init__()
        mid = num_heads * head_features
        self.num_heads, self.head_features = num_heads, head_features
        self.norm = nn.LayerNorm(features, eps=_LN_EPS)
        self.norm_context = nn.LayerNorm(features, eps=_LN_EPS)
        self.to_q = nn.Linear(features, mid, bias=False)
        self.to_kv = nn.Linear(features, mid * 2, bias=False)
        self.attention = AttentionOut(mid, features)

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        B, T, _ = x.shape
        nh, dh = self.num_heads, self.head_features
        q = self.to_q(self.norm(x)).view(B, T, nh, dh).transpose(1, 2)
        k, v = self.to_kv(self.norm_context(x)).chunk(2, dim=-1)
        k = k.reshape(B, T, nh, dh).transpose(1, 2)
        v = v.reshape(B, T, nh, dh).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
        if valid is not None:  # exclude padded keys
            logits = logits.masked_fill(valid[:, None, None, :] <= 0,
                                        torch.finfo(logits.dtype).min)
        out = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, T, nh * dh)
        return self.attention.to_out(out)


class TransformerBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, head_features: int, multiplier: int):
        super().__init__()
        self.attention = SelfAttention(features, num_heads, head_features)
        self.feed_forward = nn.Sequential(
            nn.Linear(features, features * multiplier), nn.GELU(),
            nn.Linear(features * multiplier, features),
        )

    def forward(self, x, valid=None):
        x = self.attention(x, valid) + x
        return self.feed_forward(x) + x


class Transformer1d(nn.Module):
    def __init__(self, channels: int = 256, context_embedding_features: int = 768,
                 num_layers: int = 3, num_heads: int = 8, head_features: int = 64,
                 multiplier: int = 2, embedding_max_length: int = 512):
        super().__init__()
        self.channels = channels
        M = channels + context_embedding_features
        self.fixed_embedding = FixedEmbedding(embedding_max_length, context_embedding_features)
        self.to_time = nn.Sequential(
            nn.Sequential(LearnedPositionalEmbedding(channels), nn.Linear(channels + 1, M)),
            nn.GELU(),
        )
        self.to_mapping = nn.Sequential(nn.Linear(M, M), nn.GELU(), nn.Linear(M, M), nn.GELU())
        self.blocks = nn.ModuleList(
            TransformerBlock(M, num_heads, head_features, multiplier) for _ in range(num_layers)
        )
        self.to_out = nn.Sequential(_SwapLast(), nn.Conv1d(M, channels, 1), _SwapLast())

    def _run(self, x, time, emb, valid):
        T = emb.shape[1]
        mapping = self.to_mapping(self.to_time(time))
        h = torch.cat([x.expand(-1, T, self.channels), emb], dim=-1)
        for blk in self.blocks:
            h = blk(h + mapping[:, None, :], valid)
        if valid is not None:
            h = (h * valid[..., None]).sum(dim=1, keepdim=True) / (
                valid.sum(dim=1)[:, None, None] + 1e-8)
        else:
            h = h.mean(dim=1, keepdim=True)
        return self.to_out(h)

    def forward(self, x, time, embedding, embedding_scale: float = 1.0,
                embedding_lengths: Optional[torch.Tensor] = None):
        """x (B, 1, channels) noisy style; time (B,) c_noise; embedding
        (B, T, E) PL-BERT features; embedding_lengths (B,) masks padded
        positions -> (B, 1, channels)."""
        B, T = embedding.shape[:2]
        fixed = self.fixed_embedding.embedding.weight[None, :T].expand(B, T, -1)
        valid = None
        if embedding_lengths is not None:
            valid = (torch.arange(T, device=embedding.device)[None, :]
                     < embedding_lengths.to(embedding.device)[:, None]).to(embedding.dtype)
        if embedding_scale == 1.0:
            return self._run(x, time, embedding, valid)
        # classifier-free guidance: cond and uncond in one batched pass
        out2 = self._run(
            torch.cat([x, x]), torch.cat([time, time]), torch.cat([embedding, fixed]),
            None if valid is None else torch.cat([valid, valid]),
        )
        out, out_masked = out2[:B], out2[B:]
        return out_masked + (out - out_masked) * embedding_scale

