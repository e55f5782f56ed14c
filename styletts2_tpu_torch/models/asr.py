"""ASR text aligner: CTC conv encoder + location-sensitive seq2seq decoder
(`styletts2_tpu/models/asr.py:29-216`).

mel (B, n_mels, T) -> MFCC by the ortho DCT (80 -> 40) -> stride-2 conv stem
-> n_layers x [ConvBlock (3 dilated residual convs with GroupNorm(8)) +
GroupNorm(1)] -> 1x1 projection to hidden/2: the memory (B, T/2, hidden/2).
`ASRS2S` decodes the text teacher-forced, one LSTMCell step per token plus
the leading sos step, in a Python loop, with location-sensitive attention
(a k=63 conv over the previous and cumulative weights) and a softmax masked
to the valid memory. In train mode 10% of the input tokens become `unk`
(drawn from the caller's `torch.Generator`) and dropout applies (0.2 in the
conv blocks, 0.5 on the decoder's hidden state before its logits).
Module names are the reference checkpoint's (`styletts2_tpu/convert.py:
convert_asr`), so a reference state_dict loads with `load_state_dict`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from styletts2_tpu_torch.models.layers import lecun_normal_, uniform_


def dct_matrix(n_mfcc: int = 40, n_mels: int = 80) -> np.ndarray:
    """Ortho-normalised DCT-II basis (n_mels, n_mfcc), torchaudio's create_dct."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] *= 1.0 / np.sqrt(2.0)
    return basis.astype(np.float32)


class ConvNorm(nn.Module):
    def __init__(self, cin, cout, kernel_size=1, stride=1, padding=0, dilation=1, bias=True):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel_size, stride, padding, dilation, bias=bias)

    def forward(self, x):
        return self.conv(x)


class LinearNorm(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.linear_layer = nn.Linear(cin, cout, bias=bias)

    def forward(self, x):
        return self.linear_layer(x)


class ConvBlock(nn.Module):
    """Three dilated residual sub-blocks: conv(d) -> ReLU -> GroupNorm(8) ->
    dropout -> conv -> ReLU -> dropout, added to the input."""

    def __init__(self, hidden: int = 256, n_conv: int = 3, dropout: float = 0.2):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.Sequential(
                ConvNorm(hidden, hidden, 3, padding=3 ** i, dilation=3 ** i), nn.ReLU(),
                nn.GroupNorm(8, hidden), nn.Dropout(dropout),
                ConvNorm(hidden, hidden, 3, padding=1), nn.ReLU(), nn.Dropout(dropout),
            )
            for i in range(n_conv)
        )

    def forward(self, x):
        for blk in self.blocks:
            x = x + blk(x)
        return x


class LocationLayer(nn.Module):
    def __init__(self, n_filters: int, kernel_size: int, dim: int):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel_size, padding=(kernel_size - 1) // 2,
                                      bias=False)
        self.location_dense = LinearNorm(n_filters, dim, bias=False)

    def forward(self, attn_cat):
        """(B, 2, L) previous and cumulative weights -> (B, L, dim)."""
        return self.location_dense(self.location_conv(attn_cat).transpose(1, 2))


class Attention(nn.Module):
    def __init__(self, dim: int, n_filters: int, kernel_size: int):
        super().__init__()
        self.query_layer = LinearNorm(dim, dim, bias=False)
        self.memory_layer = LinearNorm(dim, dim, bias=False)
        self.v = LinearNorm(dim, 1, bias=False)
        self.location_layer = LocationLayer(n_filters, kernel_size, dim)


class ASRS2S(nn.Module):
    def __init__(self, embedding_dim: int = 512, hidden_dim: int = 128,
                 n_location_filters: int = 32, location_kernel_size: int = 63,
                 n_token: int = 178, sos: int = 1, unk: int = 3, random_mask: float = 0.1):
        super().__init__()
        self.sos, self.unk, self.random_mask = sos, unk, random_mask
        self.embedding = nn.Embedding(n_token, embedding_dim)
        self.attention_layer = Attention(hidden_dim, n_location_filters, location_kernel_size)
        self.decoder_rnn = nn.LSTMCell(embedding_dim + hidden_dim, hidden_dim)
        self.project_to_hidden = nn.Sequential(LinearNorm(2 * hidden_dim, hidden_dim), nn.Tanh())
        self.project_to_n_symbols = nn.Linear(hidden_dim, n_token)

    def forward(self, memory, memory_valid, text_input,
                generator: Optional[torch.Generator] = None):
        """memory (B, L, H); memory_valid (B, L), 1 = valid; text_input (B, T)
        -> (hidden (B, T+1, H), logits (B, T+1, n_token), alignments (B, T+1, L))."""
        B, L, H = memory.shape
        if self.training and self.random_mask > 0:
            dev = generator.device if generator is not None else text_input.device
            mask = torch.rand(text_input.shape, generator=generator, device=dev) < self.random_mask
            text_input = text_input.masked_fill(mask.to(text_input.device), self.unk)
        sos = torch.full((B, 1), self.sos, dtype=text_input.dtype, device=text_input.device)
        dec_in = self.embedding(torch.cat([sos, text_input], dim=1))  # (B, T+1, E)
        att = self.attention_layer
        processed_memory = att.memory_layer(memory)
        neg_mask = torch.zeros((B, L), device=memory.device).masked_fill(memory_valid <= 0, -math.inf)
        h = c = ctx = memory.new_zeros((B, H))
        attn = attn_cum = memory.new_zeros((B, L))
        hiddens, logits, aligns = [], [], []
        for t in range(dec_in.shape[1]):
            h, c = self.decoder_rnn(torch.cat([dec_in[:, t], ctx], dim=-1), (h, c))
            loc = att.location_layer(torch.stack([attn, attn_cum], dim=1))
            energies = att.v(torch.tanh(att.query_layer(h)[:, None] + loc + processed_memory))
            attn = torch.softmax(energies[..., 0] + neg_mask, dim=-1)
            ctx = torch.bmm(attn[:, None], memory)[:, 0]
            attn_cum = attn_cum + attn
            hidden = self.project_to_hidden(torch.cat([h, ctx], dim=-1))
            logits.append(self.project_to_n_symbols(F.dropout(hidden, 0.5, self.training)))
            hiddens.append(hidden)
            aligns.append(attn)
        return torch.stack(hiddens, 1), torch.stack(logits, 1), torch.stack(aligns, 1)


class ASRCNN(nn.Module):
    def __init__(self, input_dim: int = 80, hidden_dim: int = 256, n_token: int = 178,
                 n_layers: int = 6, token_embedding_dim: int = 512):
        super().__init__()
        self.register_buffer("dct", torch.from_numpy(dct_matrix(input_dim // 2, input_dim)),
                             persistent=False)
        self.init_cnn = ConvNorm(input_dim // 2, hidden_dim, 7, stride=2, padding=3)
        self.cnns = nn.Sequential(*(
            nn.Sequential(ConvBlock(hidden_dim), nn.GroupNorm(1, hidden_dim))
            for _ in range(n_layers)
        ))
        self.projection = ConvNorm(hidden_dim, hidden_dim // 2)
        self.ctc_linear = nn.Sequential(LinearNorm(hidden_dim // 2, hidden_dim), nn.ReLU(),
                                        LinearNorm(hidden_dim, n_token))
        self.asr_s2s = ASRS2S(token_embedding_dim, hidden_dim // 2, n_token=n_token)

    def encode(self, mel):
        """mel (B, n_mels, T) -> memory (B, T // 2, hidden // 2)."""
        mfcc = torch.einsum("bmt,mk->bkt", mel, self.dct)
        return self.projection(self.cnns(self.init_cnn(mfcc))).transpose(1, 2)

    def forward(self, mel, memory_valid, text_input,
                generator: Optional[torch.Generator] = None):
        """-> (ctc_logits, s2s_logits, s2s_attn), the aligner triple."""
        memory = self.encode(mel)
        ctc = self.ctc_linear(memory)
        _, s2s_logit, s2s_attn = self.asr_s2s(memory, memory_valid, text_input, generator)
        return ctc, s2s_logit, s2s_attn


@torch.no_grad()
def init_asr_(m: ASRCNN, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's init distributions: lecun-normal convs and dense
    layers with zero biases, GroupNorm ones/zeros, the embedding U[0,
    2 sqrt(6 / H)) (flax's one-sided uniform), xavier-uniform attention and
    projection weights, the LSTMCell U(+-1/sqrt(H)) with one bias."""
    g = generator
    for mod in m.modules():
        if isinstance(mod, (nn.Conv1d, nn.Linear)):
            lecun_normal_(mod.weight, g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    s2s = m.asr_s2s
    H = s2s.decoder_rnn.hidden_size
    s2s.embedding.weight.copy_(torch.rand(s2s.embedding.weight.shape, generator=g)
                               * (2 * math.sqrt(6 / H)))
    att = s2s.attention_layer
    for w in (att.query_layer.linear_layer.weight, att.v.linear_layer.weight,
              att.location_layer.location_conv.conv.weight,
              att.location_layer.location_dense.linear_layer.weight,
              s2s.project_to_hidden[0].linear_layer.weight, s2s.project_to_n_symbols.weight):
        nn.init.xavier_uniform_(w, generator=g)
    bound = 1.0 / math.sqrt(H)
    cell = s2s.decoder_rnn
    uniform_(cell.weight_ih, bound, g)
    uniform_(cell.weight_hh, bound, g)
    uniform_(cell.bias_ih, bound, g)
    cell.bias_hh.zero_()  # the JAX cell has one bias, b_ih + b_hh
