"""WavLM (base plus) as plain PyTorch: the frozen speech LM of the stage-1
WavLM feature loss (`styletts2_tpu/models/wavlm.py:33-218`).

16 kHz wave (B, T) -> 7 strided convs (GroupNorm on the first, GELU) ->
LayerNorm + projection -> grouped positional conv (k 128, groups 16) ->
LayerNorm -> post-LN transformer layers with WavLM's gated relative
position bias: the bucketed bias is computed by layer 0 and shared, and
each layer gates it per head by g_a (g_b c - 1) + 2 from its input. Returns
every hidden state (embeddings + one per layer). Module names follow the
Hugging Face WavLMModel state_dict that `styletts2_tpu/convert.py:
convert_wavlm` reads, except that the positional conv carries its folded
weight (`encoder.pos_conv_embed.conv.weight`), as the JAX package keeps it.
`resample_24k_to_16k` is torchaudio's Resample(24000, 16000) as a strided
convolution (`wavlm.py:187-218`).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import lecun_normal_

CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)
CONV_DIM = 512


def _rel_pos_bucket(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
                         / math.log(max_distance / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel < max_exact, rel, large)


class ConvLayer(nn.Module):
    def __init__(self, cin: int, kernel: int, stride: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, CONV_DIM, kernel, stride, bias=False)
        if norm:  # GroupNorm(C groups): a per-channel norm over time
            self.layer_norm = nn.GroupNorm(CONV_DIM, CONV_DIM)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            ConvLayer(1 if i == 0 else CONV_DIM, k, s, i == 0)
            for i, (k, s) in enumerate(zip(CONV_KERNELS, CONV_STRIDES)))

    def forward(self, wav):
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)  # (B, frames, 512)


class FeatureProjection(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(CONV_DIM)
        self.projection = nn.Linear(CONV_DIM, hidden)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.conv = nn.Conv1d(hidden, hidden, 128, padding=64, groups=16)

    def forward(self, x):  # (B, T, H)
        return F.gelu(self.conv(x.transpose(1, 2))[..., :-1].transpose(1, 2))


class WavLMAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, has_rel_embed: bool,
                 num_buckets: int = 320, max_distance: int = 800):
        super().__init__()
        self.heads, self.num_buckets, self.max_distance = heads, num_buckets, max_distance
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(hidden, hidden) for _ in range(4))
        self.gru_rel_pos_linear = nn.Linear(hidden // heads, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        if has_rel_embed:
            self.rel_attn_embed = nn.Embedding(num_buckets, heads)

    def forward(self, x, position_bias):
        B, T, H = x.shape
        nh, dh = self.heads, H // self.heads
        if hasattr(self, "rel_attn_embed"):
            rel = np.arange(T)[None, :] - np.arange(T)[:, None]
            bucket = torch.from_numpy(_rel_pos_bucket(rel, self.num_buckets, self.max_distance))
            position_bias = self.rel_attn_embed(bucket.to(x.device)).permute(2, 0, 1)  # (nh, T, T)
        gh = x.reshape(B, T, nh, dh).transpose(1, 2)  # (B, nh, T, dh)
        gates = torch.sigmoid(self.gru_rel_pos_linear(gh).reshape(B, nh, T, 2, 4).sum(-1))
        gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
        gated_bias = (gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0) * position_bias[None]
        q, k, v = (p(x).reshape(B, T, nh, dh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = q @ k.transpose(-1, -2) * dh ** -0.5 + gated_bias
        out = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B, T, H)
        return self.out_proj(out), position_bias


class FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, has_rel_embed: bool):
        super().__init__()
        self.attention = WavLMAttention(hidden, heads, has_rel_embed)
        self.layer_norm = nn.LayerNorm(hidden)
        self.feed_forward = FeedForward(hidden, intermediate)
        self.final_layer_norm = nn.LayerNorm(hidden)

    def forward(self, x, position_bias):
        h, position_bias = self.attention(x, position_bias)
        x = self.layer_norm(x + h)
        return self.final_layer_norm(x + self.feed_forward(x)), position_bias


class Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, num_layers: int):
        super().__init__()
        self.pos_conv_embed = PosConv(hidden)
        self.layer_norm = nn.LayerNorm(hidden)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(hidden, heads, intermediate, i == 0) for i in range(num_layers))


class WavLM(nn.Module):
    """16 kHz wave (B, T) -> num_layers + 1 hidden states (B, frames, hidden)."""

    def __init__(self, hidden: int = 768, heads: int = 12, intermediate: int = 3072,
                 num_layers: int = 12):
        super().__init__()
        self.feature_extractor = FeatureExtractor()
        self.feature_projection = FeatureProjection(hidden)
        self.encoder = Encoder(hidden, heads, intermediate, num_layers)

    def forward(self, wav) -> List[torch.Tensor]:
        x = self.feature_projection(self.feature_extractor(wav))
        x = self.encoder.layer_norm(x + self.encoder.pos_conv_embed(x))
        states, position_bias = [x], None
        for layer in self.encoder.layers:
            x, position_bias = layer(x, position_bias)
            states.append(x)
        return states


@torch.no_grad()
def init_wavlm_(m: WavLM, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's init: lecun-normal convs and dense layers with zero
    biases, norms ones/zeros, the relative-position table N(0, 0.02), the
    gate constants 1."""
    for mod in m.modules():
        if isinstance(mod, (nn.Conv1d, nn.Linear)):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * 0.02)
        elif isinstance(mod, WavLMAttention):
            mod.gru_rel_pos_const.fill_(1.0)


@functools.lru_cache(maxsize=None)
def _resample_kernels() -> np.ndarray:
    """torchaudio's windowed-sinc polyphase filters for 24 kHz -> 16 kHz (in
    the gcd-reduced form, up 2, down 3): (2, K) f32."""
    orig_freq, new_freq = 3, 2
    base_freq = min(orig_freq, new_freq) * 0.99  # rolloff
    width = math.ceil(6 * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -6, 6)
    window = np.cos(t * np.pi / 6 / 2) ** 2
    return (np.where(t == 0, 1.0, np.sinc(t)) * window * base_freq / orig_freq).astype(np.float32)


def resample_24k_to_16k(wav: torch.Tensor) -> torch.Tensor:
    """(B, T) at 24 kHz -> (B, ceil(2 T / 3)) at 16 kHz."""
    kernels = torch.from_numpy(_resample_kernels()).to(wav.device, wav.dtype)
    width = (kernels.shape[1] - 3) // 2
    x = F.pad(wav, (width, width + 3))[:, None]
    y = F.conv1d(x, kernels[:, None], stride=3)  # (B, 2, frames)
    y = y.transpose(1, 2).reshape(wav.shape[0], -1)
    return y[:, : math.ceil(2 * wav.shape[1] / 3)]
