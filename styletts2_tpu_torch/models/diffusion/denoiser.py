"""Style denoisers (`styletts2_tpu/models/diffusion/denoiser.py`):
Transformer1d (single-speaker, style_cond=False) and StyleTransformer1d
(multispeaker, style_cond=True).

The (B, 1, channels) noisy style is broadcast along the PL-BERT sequence,
concatenated with it, run through pre-LN transformer blocks with a
time-mapping vector added before each, mean-pooled over the valid positions
and projected back. Padded keys are masked out of the attention with
finfo.min, and classifier-free guidance runs cond and uncond as one batched
pass. The multispeaker net also maps the reference style `features` into
the mapping vector and normalises the attention inputs with AdaLayerNorms
conditioned on them. In training an `embedding_mask` (`draw_embedding_mask`)
swaps the PL-BERT embedding of the items it marks for the fixed one. Attention is plain tensor ops. Module names follow the
reference checkpoint (`styletts2_tpu/convert.py:convert_diffusion`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from styletts2_tpu_torch.models.layers import AdaLayerNorm

# flax.linen.LayerNorm's default epsilon, which the JAX single-speaker
# denoiser uses; its AdaLayerNorm keeps 1e-5
_LN_EPS = 1e-6


def draw_embedding_mask(batch: int, proba: float, generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """(batch,) bool, each item True with probability `proba`, drawn from
    `generator`: the items whose embedding the denoiser swaps."""
    return torch.rand((batch,), generator=generator, device=device) < proba


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
    inputs, as the reference has; AdaLayerNorms on the style features when
    `style_dim` > 0."""

    def __init__(self, features: int, num_heads: int, head_features: int, style_dim: int = 0):
        super().__init__()
        mid = num_heads * head_features
        self.num_heads, self.head_features = num_heads, head_features
        if style_dim:
            self.norm = AdaLayerNorm(style_dim, features)
            self.norm_context = AdaLayerNorm(style_dim, features)
        else:
            self.norm = nn.LayerNorm(features, eps=_LN_EPS)
            self.norm_context = nn.LayerNorm(features, eps=_LN_EPS)
        self.to_q = nn.Linear(features, mid, bias=False)
        self.to_kv = nn.Linear(features, mid * 2, bias=False)
        self.attention = AttentionOut(mid, features)

    def forward(self, x, s=None, valid: Optional[torch.Tensor] = None):
        B, T, _ = x.shape
        nh, dh = self.num_heads, self.head_features
        norm_args = (x,) if s is None else (x, s)
        q = self.to_q(self.norm(*norm_args)).view(B, T, nh, dh).transpose(1, 2)
        k, v = self.to_kv(self.norm_context(*norm_args)).chunk(2, dim=-1)
        k = k.reshape(B, T, nh, dh).transpose(1, 2)
        v = v.reshape(B, T, nh, dh).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
        if valid is not None:  # exclude padded keys
            logits = logits.masked_fill(valid[:, None, None, :] <= 0,
                                        torch.finfo(logits.dtype).min)
        out = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, T, nh * dh)
        return self.attention.to_out(out)


class TransformerBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, head_features: int, multiplier: int,
                 style_dim: int = 0):
        super().__init__()
        self.attention = SelfAttention(features, num_heads, head_features, style_dim)
        self.feed_forward = nn.Sequential(
            nn.Linear(features, features * multiplier), nn.GELU(),
            nn.Linear(features * multiplier, features),
        )

    def forward(self, x, s=None, valid=None):
        x = self.attention(x, s, valid) + x
        return self.feed_forward(x) + x


class Transformer1d(nn.Module):
    """With `context_features` > 0 this is the multispeaker
    StyleTransformer1d: `features` (B, context_features) enter the mapping
    through `to_features` and condition every attention norm."""

    def __init__(self, channels: int = 256, context_embedding_features: int = 768,
                 num_layers: int = 3, num_heads: int = 8, head_features: int = 64,
                 multiplier: int = 2, embedding_max_length: int = 512,
                 context_features: int = 0):
        super().__init__()
        self.channels = channels
        M = channels + context_embedding_features
        self.fixed_embedding = FixedEmbedding(embedding_max_length, context_embedding_features)
        self.to_time = nn.Sequential(
            nn.Sequential(LearnedPositionalEmbedding(channels), nn.Linear(channels + 1, M)),
            nn.GELU(),
        )
        if context_features:
            self.to_features = nn.Sequential(nn.Linear(context_features, M), nn.GELU())
        self.to_mapping = nn.Sequential(nn.Linear(M, M), nn.GELU(), nn.Linear(M, M), nn.GELU())
        self.blocks = nn.ModuleList(
            TransformerBlock(M, num_heads, head_features, multiplier, context_features)
            for _ in range(num_layers)
        )
        self.to_out = nn.Sequential(_SwapLast(), nn.Conv1d(M, channels, 1), _SwapLast())

    def _run(self, x, time, emb, feats, valid):
        T = emb.shape[1]
        items = self.to_time(time)
        if feats is not None:
            items = items + self.to_features(feats)
        mapping = self.to_mapping(items)
        h = torch.cat([x.expand(-1, T, self.channels), emb], dim=-1)
        for blk in self.blocks:
            h = blk(h + mapping[:, None, :], feats, valid)
        if valid is not None:
            h = (h * valid[..., None]).sum(dim=1, keepdim=True) / (
                valid.sum(dim=1)[:, None, None] + 1e-8)
        else:
            h = h.mean(dim=1, keepdim=True)
        return self.to_out(h)

    def forward(self, x, time, embedding, embedding_scale: float = 1.0,
                embedding_lengths: Optional[torch.Tensor] = None,
                features: Optional[torch.Tensor] = None,
                embedding_mask: Optional[torch.Tensor] = None):
        """x (B, 1, channels) noisy style; time (B,) c_noise; embedding
        (B, T, E) PL-BERT features; embedding_lengths (B,) masks padded
        positions; features (B, context_features) the reference style of the
        multispeaker net; embedding_mask (B,) bool, True where the fixed
        embedding replaces the item's -> (B, 1, channels)."""
        if (features is None) != (not hasattr(self, "to_features")):
            raise ValueError("`features` are needed by, and only by, the multispeaker denoiser")
        B, T = embedding.shape[:2]
        fixed = self.fixed_embedding.embedding.weight[None, :T].expand(B, T, -1)
        if embedding_mask is not None:
            embedding = torch.where(embedding_mask.to(embedding.device)[:, None, None], fixed,
                                    embedding)
        valid = None
        if embedding_lengths is not None:
            valid = (torch.arange(T, device=embedding.device)[None, :]
                     < embedding_lengths.to(embedding.device)[:, None]).to(embedding.dtype)
        if embedding_scale == 1.0:
            return self._run(x, time, embedding, features, valid)
        # classifier-free guidance: cond and uncond in one batched pass
        out2 = self._run(
            torch.cat([x, x]), torch.cat([time, time]), torch.cat([embedding, fixed]),
            None if features is None else torch.cat([features, features]),
            None if valid is None else torch.cat([valid, valid]),
        )
        out, out_masked = out2[:B], out2[B:]
        return out_masked + (out - out_masked) * embedding_scale

