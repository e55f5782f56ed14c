"""Core building blocks, NCW layout (batch, channels, time); NCHW for the
2D convolutions of the style encoders.

Counterparts of `styletts2_tpu/models/layers.py`. Parameter names follow the
reference torch checkpoints that `styletts2_tpu/convert.py` reads (weight_v,
weight_g, bias; LSTM weight_ih_l0...), so `convert.state_dict_from_jax` is a
rename-and-transpose.

Under bf16 (the bf16 decoder, bf16 training) a convolution computes in its
weight's dtype, its input cast to it, as the JAX package's raw convs do;
weight norm, spectral norm and the normalisation statistics stay f32
islands.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

LRELU_SLOPE_02 = 0.2


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax's lecun_normal: a normal truncated at 2 std, variance 1 / fan_in
    (fan_in = every axis of a torch weight but the first)."""
    std = 1.0 / math.sqrt(w[0].numel()) / 0.87962566103423978
    t = torch.empty(w.shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    w.copy_(t)


@torch.no_grad()
def uniform_(w: torch.Tensor, bound: float, generator: Optional[torch.Generator] = None) -> None:
    """U(-bound, bound)."""
    w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE_02) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(alpha x) / alpha."""
    s = torch.sin(alpha * x)
    return x + (s * s) / alpha


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v|| with the norm over every axis but the first, and 1e-12
    inside the square root as in the JAX package (not torch's weight_norm).
    Computed in f32 from v and g as they are (bf16-rounded under bf16: a
    bf16 sum over a kernel's elements loses ~1% per layer), returned in v's
    dtype."""
    v32 = v.float()
    dims = tuple(range(1, v.dim()))
    return (v32 / torch.sqrt(torch.sum(v32 * v32, dim=dims, keepdim=True) + 1e-12)
            * g.float()).to(v.dtype)


class WNConv1d(nn.Module):
    """Weight-normalised Conv1d: weight_v (out, in/groups, K), weight_g (out, 1, 1)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, bias=True):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    @property
    def weight(self) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g)

    def forward(self, x):
        w = self.weight
        return F.conv1d(x.to(w.dtype), w, self.bias, self.stride, self.padding, self.dilation,
                        self.groups)


class WNConvTranspose1d(nn.Module):
    """Weight-normalised ConvTranspose1d: weight_v in torch's (in, out/groups,
    K) layout, normalised per input channel; g=1 or depthwise groups=C."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=2, padding=1,
                 output_padding=1, groups=1, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding, self.groups = output_padding, groups
        self.weight_v = nn.Parameter(torch.empty(in_ch, out_ch // groups, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        w = weight_norm(self.weight_v, self.weight_g)
        return F.conv_transpose1d(
            x.to(w.dtype), w, self.bias, self.stride, self.padding, self.output_padding, self.groups
        )


class SNConv2d(nn.Module):
    """Spectral-normalised Conv2d, NCHW (`styletts2_tpu/models/layers.py:199-268`).

    torch `spectral_norm`'s names: the parameter `weight_orig` (out, in/groups,
    kh, kw) and the buffers `weight_u` (out,) and `weight_v` (in/groups*kh*kw,)
    in that flattening order. The weight is divided by sigma = u . (W_mat v);
    sigma keeps its gradient through W, never through (u, v).

    `update_stats` says which (u, v) a call uses, in either mode:
    - False: the stored vectors.
    - True: one power iteration in f32 (norms + 1e-12) whose result is used
      now but stored only by `commit_spectral_updates`, so that the step's
      other passes see the vectors the step began with (the JAX package's
      `update_stats=True` passes, folded in after the optimizer step).
    The iteration and sigma are f32 whatever the weight's dtype, and (u, v)
    stay f32 buffers; the convolution runs in the weight's dtype."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight_orig = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh, kw))
        self.register_buffer("weight_u", torch.zeros(out_ch))
        self.register_buffer("weight_v", torch.zeros(in_ch // groups * kh * kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.pending = None  # (u, v) of an update_stats=True call, until committed

    def forward(self, x, update_stats: bool = False):
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1).float()
        u, v = self.weight_u, self.weight_v
        if update_stats:
            with torch.no_grad():
                v = w_mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + 1e-12)
                u = w_mat @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
                self.pending = (u, v)
        sigma = u @ (w_mat @ v)
        return F.conv2d(x.to(w.dtype), w / sigma.to(w.dtype), self.bias, self.stride,
                        self.padding, 1, self.groups)


@torch.no_grad()
def commit_spectral_updates(root: nn.Module) -> None:
    """Store the (u, v) that `update_stats=True` calls left pending in
    every SNConv2d under `root`."""
    for mod in root.modules():
        if isinstance(mod, SNConv2d) and mod.pending is not None:
            mod.weight_u.copy_(mod.pending[0])
            mod.weight_v.copy_(mod.pending[1])
            mod.pending = None


def avg_pool_2d_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H // 2, ceil(W / 2)): the reference's 'half'
    downsample repeats the last column on an odd W; avg_pool2d floors an
    odd H."""
    if x.shape[-1] % 2:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    return F.avg_pool2d(x, 2)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each (b, c) row of (B, C, T) over time, statistics in f32."""
    xs = x.float()
    mean = xs.mean(dim=-1, keepdim=True)
    var = xs.var(dim=-1, unbiased=False, keepdim=True)
    return ((xs - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of (B, C, T) with learned gamma/beta."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.transpose(1, 2), (x.shape[1],), self.gamma, self.beta, self.eps)
        return y.transpose(1, 2)


class StyleAffine(nn.Module):
    """Style -> (gamma, beta), each (B, C)."""

    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, num_features * 2)

    def forward(self, s):
        return self.fc(s).chunk(2, dim=-1)


class AdaIN1d(StyleAffine):
    """Style-conditional instance norm of (B, C, T)."""

    def forward(self, x, s):
        gamma, beta = super().forward(s)
        return (1.0 + gamma[:, :, None]) * instance_norm(x) + beta[:, :, None]


class AdaLayerNorm(StyleAffine):
    """Style-conditional LayerNorm over the channels of (B, T, C)."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5):
        super().__init__(style_dim, channels)
        self.eps = eps

    def forward(self, x, s):
        gamma, beta = super().forward(s)
        y = F.layer_norm(x, (x.shape[-1],), eps=self.eps)
        return (1.0 + gamma[:, None, :]) * y + beta[:, None, :]


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 2T), nearest."""
    return torch.repeat_interleave(x, 2, dim=-1)


_MASKED_LSTMS = contextvars.ContextVar("masked_lstms", default=False)


@contextlib.contextmanager
def masked_lstms():
    """Within it, every `BiLSTM` given lengths runs `BiLSTM.masked`, which
    never reads the lengths on the host, so that a CUDA graph can capture
    it; the single-dispatch programs of `inference.py` run under it.
    Elsewhere the lengths go through `pack_padded_sequence`."""
    token = _MASKED_LSTMS.set(True)
    try:
        yield
    finally:
        _MASKED_LSTMS.reset(token)


class BiLSTM(nn.LSTM):
    """Bidirectional one-layer LSTM on (B, T, C) -> (B, T, 2H).

    With `lengths` (B,), padded steps output 0 and the reverse direction
    starts at each row's last valid step, as the JAX package's masked scan
    does; that is `pack_padded_sequence` semantics, which reads the lengths
    on the host, or `masked` under `masked_lstms()`.

    On a card every call goes through cuDNN's packed path, full rows packed
    at their full length (`_full`): at narrow widths (hidden 32) its
    unpacked path computes the output and the input gradient 5.8e-6 and
    6.1e-6 off an f64 reference on an H100, where f32 gives 1.6e-7 and
    2.6e-7, whatever torch's precision flags; the packed path is f32 at
    every width and as fast (tools/lstm_precision_torch.py)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__(input_size, hidden, num_layers=1, batch_first=True,
                         bidirectional=True)

    def forward(self, x, lengths: Optional[torch.Tensor] = None):
        T = x.shape[1]
        if lengths is not None and _MASKED_LSTMS.get():
            return self.masked(x, lengths)
        if lengths is None or bool((lengths >= T).all()):
            return self._full(x)
        packed = pack_padded_sequence(x, lengths.cpu().to(torch.int64), batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        return pad_packed_sequence(out, batch_first=True, total_length=T)[0]

    def _full(self, x: torch.Tensor) -> torch.Tensor:
        """Every row at its full length: on a card packed (lengths built on
        the host, no sync), elsewhere as it is."""
        if not x.is_cuda:
            return super().forward(x)[0]
        B, T = x.shape[:2]
        packed = pack_padded_sequence(x, torch.full((B,), T, dtype=torch.int64), batch_first=True)
        return pad_packed_sequence(super().forward(packed)[0], batch_first=True,
                                   total_length=T)[0]

    def masked(self, x, lengths: torch.Tensor) -> torch.Tensor:
        """The packed semantics with no host sync and no data-dependent
        shape: one LSTM call over 2B rows, x as it is (its forward direction
        reads each row's valid steps first) and x with each row rolled right
        by T - length, its valid steps last (the reverse direction reads
        them first, the padding after); the reverse outputs are rolled back
        and the padded steps zeroed."""
        B, T, _ = x.shape
        lengths = lengths.to(x.device)[:, None]
        t = torch.arange(T, device=x.device)[None, :]
        right = ((t + lengths) % T)[..., None]  # right[b, t] = x[b, (t + L) mod T]
        xr = torch.gather(x, 1, right.expand(-1, -1, x.shape[2]))
        out = self._full(torch.cat([x, xr]))
        H = self.hidden_size
        back = ((t + T - lengths) % T)[..., None].expand(-1, -1, H)
        rev = torch.gather(out[B:, :, H:], 1, back)
        return torch.cat([out[:B, :, :H], rev], dim=-1).masked_fill(~(t < lengths)[..., None], 0.0)
