"""PL-BERT: phoneme-level ALBERT in plain PyTorch (`styletts2_tpu/models/plbert.py`).

Factorised embedding (vocab -> embedding_size -> hidden) and ONE shared
transformer layer applied num_hidden_layers times; post-LN with eps 1e-12,
gelu_new (tanh GELU), additive mask (1 - m) * -1e9. Module names follow
HF `AlbertModel`'s state_dict, which `styletts2_tpu/convert.py` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.config import PLBERTParams


class AlbertEmbeddings(nn.Module):
    def __init__(self, c: PLBERTParams):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.embedding_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.embedding_size)
        self.token_type_embeddings = nn.Embedding(2, c.embedding_size)
        self.LayerNorm = nn.LayerNorm(c.embedding_size, eps=1e-12)

    def forward(self, tokens):
        T = tokens.shape[1]
        emb = (self.word_embeddings(tokens) + self.position_embeddings.weight[None, :T]
               + self.token_type_embeddings.weight[0])
        return self.LayerNorm(emb)


class AlbertAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.dense = nn.Linear(hidden, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, h, attn_bias):
        B, T, H = h.shape
        nh = self.num_heads
        dh = H // nh
        q = self.query(h).view(B, T, nh, dh).transpose(1, 2)
        k = self.key(h).view(B, T, nh, dh).transpose(1, 2)
        v = self.value(h).view(B, T, nh, dh).transpose(1, 2)
        logits = q @ k.transpose(-1, -2) / math.sqrt(dh) + attn_bias
        ctx = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, T, H)
        return self.LayerNorm(h + self.dense(ctx))


class AlbertLayer(nn.Module):
    def __init__(self, hidden: int, num_heads: int, intermediate: int):
        super().__init__()
        self.attention = AlbertAttention(hidden, num_heads)
        self.ffn = nn.Linear(hidden, intermediate)
        self.ffn_output = nn.Linear(intermediate, hidden)
        self.full_layer_layer_norm = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, h, attn_bias):
        h = self.attention(h, attn_bias)
        f = self.ffn_output(F.gelu(self.ffn(h), approximate="tanh"))
        return self.full_layer_layer_norm(h + f)


class AlbertLayerGroup(nn.Module):
    def __init__(self, c: PLBERTParams):
        super().__init__()
        self.albert_layers = nn.ModuleList(
            [AlbertLayer(c.hidden_size, c.num_attention_heads, c.intermediate_size)]
        )


class AlbertEncoder(nn.Module):
    def __init__(self, c: PLBERTParams):
        super().__init__()
        self.embedding_hidden_mapping_in = nn.Linear(c.embedding_size, c.hidden_size)
        self.albert_layer_groups = nn.ModuleList([AlbertLayerGroup(c)])


class PLBERT(nn.Module):
    def __init__(self, c: PLBERTParams):
        super().__init__()
        self.num_hidden_layers = c.num_hidden_layers
        self.embeddings = AlbertEmbeddings(c)
        self.encoder = AlbertEncoder(c)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) int, attention_mask (B, T) 1 = valid -> (B, T, hidden)."""
        h = self.encoder.embedding_hidden_mapping_in(self.embeddings(tokens))
        attn_bias = (1.0 - attention_mask.to(h.dtype))[:, None, None, :] * -1e9
        layer = self.encoder.albert_layer_groups[0].albert_layers[0]
        for _ in range(self.num_hidden_layers):
            h = layer(h, attn_bias)
        return h
