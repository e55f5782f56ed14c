"""StyleTTS 2's synthesis path in plain PyTorch: the benchmark's reference.

Each module is a function of a state dict, read by the names of the
reference checkpoints (yl4579/StyleTTS2 `models.py`, `Modules/*`, PL-BERT's
ALBERT): the text encoder, PL-BERT and bert_encoder, the style diffusion
denoiser (Transformer1d, or StyleTransformer1d when multispeaker) under EDM
preconditioning with the ADPM2 sampler, the prosody predictor (durations,
F0 and energy), the iSTFTNet or HiFi-GAN decoder with its harmonic-plus-
noise source, and the mel style encoders. Everything is eager float32 with
no kernel of its own, no cache and no CUDA graph; the AdaIN+snake chain of
the decoders' resblocks is written out (`adain_snake`). `param_specs`
lists every tensor the path reads, with its shape and the distribution the
benchmark draws it from.

Random draws follow the synthesis API's documented order, from one
generator: the sampler's churn (one N(0, 1) draw shaped like the style per
step after the first), then the source's initial phases (U(0, 1), (B, 9))
and its additive noise (N(0, 1), (B, L, 9)).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

Spec = Tuple[Tuple[int, ...], str, float]  # shape, init kind, its scale
# The gain on the F0 projection's drawn scale. Random weights give an F0
# curve of a few Hz about 0 that now and then crosses the sine source's
# 10 Hz voicing threshold. Where a row has a voiced sample its source holds
# the sines, whose phase sums F0 over every sample before it, and the
# iSTFTNet decoder reads the source's STFT angle: moving F0 by one part in a
# million then moves the row's waveform by 15-30% of its peak (tiny widths,
# CPU), against under 1e-6 for an unvoiced row, so no comparison with a
# reference can hold a voiced row. At this gain the curve stays an order
# under the threshold and every row is unvoiced.
F0_GAIN = 0.25


# ---------------------------------------------------------------------------
# the tensors the path reads

class _Specs:
    def __init__(self):
        self.out: Dict[str, Spec] = {}

    def add(self, name, shape, kind, scale=0.0):
        self.out[name] = (tuple(int(s) for s in shape), kind, float(scale))

    def linear(self, p, i, o, bias=True):
        self.add(f"{p}.weight", (o, i), "lecun", 1.0 / math.sqrt(i))
        if bias:
            self.add(f"{p}.bias", (o,), "zeros")

    def conv(self, p, i, o, k, groups=1, bias=True):
        b = 1.0 / math.sqrt(i // groups * k)
        self.add(f"{p}.weight", (o, i // groups, k), "uniform", b)
        if bias:
            self.add(f"{p}.bias", (o,), "uniform", b)

    def wnconv(self, p, i, o, k, groups=1, bias=True, g="ones"):
        b = 1.0 / math.sqrt(i // groups * k)
        self.add(f"{p}.weight_v", (o, i // groups, k), "uniform", b)
        self.add(f"{p}.weight_g", (o, 1, 1), g)
        if bias:
            self.add(f"{p}.bias", (o,), "uniform", b)

    def wnconv_t(self, p, i, o, k, groups=1, g="ones"):
        b = 1.0 / math.sqrt(i * k // groups)
        self.add(f"{p}.weight_v", (i, o // groups, k), "uniform", b)
        self.add(f"{p}.weight_g", (i, 1, 1), g)
        self.add(f"{p}.bias", (o,), "uniform", b)

    def lstm(self, p, i, h):
        b = 1.0 / math.sqrt(h)
        for sfx in ("", "_reverse"):
            self.add(f"{p}.weight_ih_l0{sfx}", (4 * h, i), "uniform", b)
            self.add(f"{p}.weight_hh_l0{sfx}", (4 * h, h), "uniform", b)
            self.add(f"{p}.bias_ih_l0{sfx}", (4 * h,), "uniform", b)
            self.add(f"{p}.bias_hh_l0{sfx}", (4 * h,), "zeros")

    def norm(self, p, n, names=("weight", "bias")):
        self.add(f"{p}.{names[0]}", (n,), "ones")
        self.add(f"{p}.{names[1]}", (n,), "zeros")

    def snconv(self, p, i, o, k, groups=1, bias=True):
        b = 1.0 / math.sqrt(i // groups * k * k)
        self.add(f"{p}.weight_orig", (o, i // groups, k, k), "uniform", b)
        if bias:
            self.add(f"{p}.bias", (o,), "uniform", b)
        self.add(f"{p}.weight_u", (o,), "sn_u")
        self.add(f"{p}.weight_v", (i // groups * k * k,), "sn_v")

    def adain_resblk(self, p, din, dout, sd, upsample=False, g="ones"):
        self.linear(f"{p}.norm1.fc", sd, 2 * din)
        self.linear(f"{p}.norm2.fc", sd, 2 * dout)
        self.wnconv(f"{p}.conv1", din, dout, 3, g=g)
        self.wnconv(f"{p}.conv2", dout, dout, 3, g=g)
        if upsample:
            self.wnconv_t(f"{p}.pool", din, din, 3, groups=din, g=g)
        if din != dout:
            self.wnconv(f"{p}.conv1x1", din, dout, 1, bias=False, g=g)

    def snake_resblock(self, p, c, k, dilations, sd, g):
        for j, _ in enumerate(dilations):
            self.wnconv(f"{p}.convs1.{j}", c, c, k, g=g)
            self.wnconv(f"{p}.convs2.{j}", c, c, k, g=g)
            self.linear(f"{p}.adain1.{j}.fc", sd, 2 * c)
            self.linear(f"{p}.adain2.{j}.fc", sd, 2 * c)
            self.add(f"{p}.alpha1.{j}", (1, c, 1), "ones")
            self.add(f"{p}.alpha2.{j}", (1, c, 1), "ones")


def param_specs(cfg: dict) -> Dict[str, Spec]:
    """{name: (shape, kind, scale)} of every tensor synthesis reads under
    `cfg` (the configuration file's `model_params` and `plbert_params`).
    Kinds: uniform (U(+-scale)), lecun (normal truncated at 2 std, std
    scale), normal (std scale), zeros, ones, wn_norm (a weight-norm gain
    equal to ||v||, so that w = v), sn_u / sn_v (a spectral-norm conv's
    power-iteration vectors, aligned with its weight)."""
    mp, pb = cfg["model_params"], cfg["plbert_params"]
    H, sd, nl = mp["hidden_dim"], mp["style_dim"], mp["n_layer"]
    s = _Specs()
    # text encoder
    s.add("text_encoder.embedding.weight", (mp["n_token"], H), "normal", 1.0 / math.sqrt(H))
    for i in range(nl):
        s.wnconv(f"text_encoder.cnn.{i}.0", H, H, 5)
        s.norm(f"text_encoder.cnn.{i}.1", H, ("gamma", "beta"))
    s.lstm("text_encoder.lstm", H, H // 2)
    # PL-BERT (ALBERT, one shared layer)
    E, Hb = pb["embedding_size"], pb["hidden_size"]
    s.add("bert.embeddings.word_embeddings.weight", (pb["vocab_size"], E), "normal",
          1.0 / math.sqrt(E))
    s.add("bert.embeddings.position_embeddings.weight", (pb["max_position_embeddings"], E),
          "normal", 0.02)
    s.add("bert.embeddings.token_type_embeddings.weight", (2, E), "normal", 0.02)
    s.norm("bert.embeddings.LayerNorm", E)
    s.linear("bert.encoder.embedding_hidden_mapping_in", E, Hb)
    lay = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    for n in ("query", "key", "value", "dense"):
        s.linear(f"{lay}.attention.{n}", Hb, Hb)
    s.norm(f"{lay}.attention.LayerNorm", Hb)
    s.linear(f"{lay}.ffn", Hb, pb["intermediate_size"])
    s.linear(f"{lay}.ffn_output", pb["intermediate_size"], Hb)
    s.norm(f"{lay}.full_layer_layer_norm", Hb)
    s.linear("bert_encoder", Hb, H)
    # prosody predictor
    for j in range(nl):
        s.lstm(f"predictor.text_encoder.lstms.{2 * j}", H + sd, H // 2)
        s.linear(f"predictor.text_encoder.lstms.{2 * j + 1}.fc", sd, 2 * H)
    s.lstm("predictor.lstm", H + sd, H // 2)
    s.linear("predictor.duration_proj.linear_layer", H, mp["max_dur"])
    s.lstm("predictor.shared", H + sd, H // 2)
    for br in ("F0", "N"):
        s.adain_resblk(f"predictor.{br}.0", H, H, sd)
        s.adain_resblk(f"predictor.{br}.1", H, H // 2, sd, upsample=True)
        s.adain_resblk(f"predictor.{br}.2", H // 2, H // 2, sd)
        s.conv(f"predictor.{br}_proj", H // 2, 1, 1)
    for n in ("weight", "bias"):
        shape, kind, scale = s.out[f"predictor.F0_proj.{n}"]
        s.add(f"predictor.F0_proj.{n}", shape, kind, F0_GAIN * scale)
    # decoder
    dec = mp["decoder"]
    hifigan = dec["type"] == "hifigan"
    ch0 = dec["upsample_initial_channel"]
    s.wnconv("decoder.F0_conv", 1, 1, 3)
    s.wnconv("decoder.N_conv", 1, 1, 3)
    s.adain_resblk("decoder.encode", H + 2, 1024, sd)
    s.wnconv("decoder.asr_res.0", H, 64, 1)
    for i in range(3):
        s.adain_resblk(f"decoder.decode.{i}", 1024 + 2 + 64, 1024, sd)
    s.adain_resblk("decoder.decode.3", 1024 + 2 + 64, ch0, sd, upsample=True)
    g = "wn_norm" if hifigan else "ones"
    rates, kernels = dec["upsample_rates"], dec["upsample_kernel_sizes"]
    n_src = 1 if hifigan else dec["gen_istft_n_fft"] + 2
    gp = "decoder.generator"
    s.linear(f"{gp}.m_source.l_linear", 9, 1)
    c_cur = ch0
    for i, (u, k) in enumerate(zip(rates, kernels)):
        c_prev, c_cur = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        s.wnconv_t(f"{gp}.ups.{i}", c_prev, c_cur, k, g=g)
        if i + 1 < len(rates):
            stride_f0 = int(np.prod(rates[i + 1:]))
            s.conv(f"{gp}.noise_convs.{i}", n_src, c_cur, stride_f0 * 2)
            s.snake_resblock(f"{gp}.noise_res.{i}", c_cur, 7, (1, 3, 5), sd, g)
        else:
            s.conv(f"{gp}.noise_convs.{i}", n_src, c_cur, 1)
            s.snake_resblock(f"{gp}.noise_res.{i}", c_cur, 11, (1, 3, 5), sd, g)
        for j, (rk, rd) in enumerate(zip(dec["resblock_kernel_sizes"],
                                         dec["resblock_dilation_sizes"])):
            s.snake_resblock(f"{gp}.resblocks.{i * len(dec['resblock_kernel_sizes']) + j}",
                             c_cur, rk, rd, sd, g)
    if hifigan:
        for i in range(len(rates) + 1):
            s.add(f"{gp}.alphas.{i}", (1, ch0 // 2 ** i, 1), "ones")
    s.wnconv(f"{gp}.conv_post", c_cur, n_src, 7, g=g)
    # style diffusion denoiser
    tr = mp["diffusion"]["transformer"]
    ch, ctx = 2 * sd, (2 * sd if mp["multispeaker"] else 0)
    M = ch + Hb
    mid = tr["num_heads"] * tr["head_features"]
    s.add("diffusion.fixed_embedding.embedding.weight", (pb["max_position_embeddings"], Hb),
          "normal", 1.0)
    s.add("diffusion.to_time.0.0.weights", (ch // 2,), "normal", 1.0)
    s.linear("diffusion.to_time.0.1", ch + 1, M)
    if ctx:
        s.linear("diffusion.to_features.0", ctx, M)
    s.linear("diffusion.to_mapping.0", M, M)
    s.linear("diffusion.to_mapping.2", M, M)
    for b in range(tr["num_layers"]):
        p = f"diffusion.blocks.{b}"
        for n in ("norm", "norm_context"):
            if ctx:
                s.linear(f"{p}.attention.{n}.fc", ctx, 2 * M)
            else:
                s.norm(f"{p}.attention.{n}", M)
        s.linear(f"{p}.attention.to_q", M, mid, bias=False)
        s.linear(f"{p}.attention.to_kv", M, 2 * mid, bias=False)
        s.linear(f"{p}.attention.attention.to_out", mid, M)
        s.linear(f"{p}.feed_forward.0", M, M * tr["multiplier"])
        s.linear(f"{p}.feed_forward.2", M * tr["multiplier"], M)
    s.add("diffusion.to_out.1.weight", (ch, M, 1), "lecun", 1.0 / math.sqrt(M))
    s.add("diffusion.to_out.1.bias", (ch,), "zeros")
    # the mel style encoders of a multispeaker model
    if mp["multispeaker"]:
        for enc in ("style_encoder", "predictor_encoder"):
            s.snconv(f"{enc}.shared.0", 1, mp["dim_in"], 3)
            d = mp["dim_in"]
            for r in range(4):
                d_out = min(d * 2, H)
                p = f"{enc}.shared.{r + 1}"
                s.snconv(f"{p}.conv1", d, d, 3)
                s.snconv(f"{p}.downsample_res.conv", d, d, 3, groups=d)
                s.snconv(f"{p}.conv2", d, d_out, 3)
                if d != d_out:
                    s.snconv(f"{p}.conv1x1", d, d_out, 1, bias=False)
                d = d_out
            s.snconv(f"{enc}.shared.6", d, d, 5)
            s.linear(f"{enc}.unshared", d, sd)
    return s.out


# ---------------------------------------------------------------------------
# layers

def leaky(x, slope=0.2):
    return F.leaky_relu(x, slope)


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def adain_snake(x, gamma, beta, alpha, eps=1e-5):
    """AdaIN (instance norm, (1 + gamma) y + beta) then snake y + sin^2(a y) / a."""
    y = (1.0 + gamma[:, :, None]) * instance_norm(x, eps) + beta[:, :, None]
    a = alpha[None, :, None]
    s = torch.sin(a * y)
    return y + s * s / a


def snake(x, alpha):
    s = torch.sin(alpha * x)
    return x + s * s / alpha


def _bucket(n: int, step: int) -> int:
    return max(step, -(-n // step) * step)


def karras_sigmas(steps: int, sigma_min=1e-4, sigma_max=3.0, rho=9.0) -> np.ndarray:
    ramp = np.arange(steps, dtype=np.float64) / (steps - 1)
    s = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


def hann(n_fft: int, win: int) -> np.ndarray:
    n = np.arange(win + 1)
    w = (0.5 - 0.5 * np.cos(2 * np.pi * n / win))[:win]
    out = np.zeros(n_fft)
    lpad = (n_fft - win) // 2
    out[lpad: lpad + win] = w
    return out.astype(np.float32)


def mel_filterbank(n_freqs: int, n_mels: int, rate: int = 16000) -> np.ndarray:
    """HTK triangles from 0 Hz to `rate` / 2, no area normalisation:
    torchaudio's `melscale_fbanks(norm=None, mel_scale="htk")` at its 16 kHz
    default, which StyleTTS 2's 24 kHz mel front end keeps."""
    to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)
    to_hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    freqs = np.linspace(0.0, rate / 2.0, n_freqs)
    pts = to_hz(np.linspace(0.0, to_mel(rate / 2.0), n_mels + 2))
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


class Reference:
    """The synthesis path on `sd` (tensors on one device, float32)."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor]):
        self.cfg, self.sd = cfg, sd
        mp = cfg["model_params"]
        self.mp, self.pb = mp, cfg["plbert_params"]
        self.sdim = mp["style_dim"]
        self.multispeaker = mp["multispeaker"]
        self.dec = mp["decoder"]
        self.hifigan = self.dec["type"] == "hifigan"
        self.device = next(iter(sd.values())).device
        self._lstms: Dict[str, nn.LSTM] = {}
        self.k1_sites: Optional[List[Tuple[int, int]]] = None  # (C, T) of each AdaIN+snake, when recording

    def w(self, name):
        return self.sd[name]

    # -- layers on the state dict -------------------------------------------
    def linear(self, p, x, bias=True):
        return F.linear(x, self.w(f"{p}.weight"), self.sd.get(f"{p}.bias") if bias else None)

    def wn(self, p):
        v, g = self.w(f"{p}.weight_v"), self.w(f"{p}.weight_g")
        return v / torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())), keepdim=True) + 1e-12) * g

    def wnconv(self, p, x, stride=1, padding=0, dilation=1, groups=1):
        return F.conv1d(x, self.wn(p), self.sd.get(f"{p}.bias"), stride, padding, dilation, groups)

    def wnconv_t(self, p, x, stride, padding, output_padding, groups=1):
        return F.conv_transpose1d(x, self.wn(p), self.w(f"{p}.bias"), stride, padding,
                                  output_padding, groups)

    def snconv(self, p, x, stride=1, padding=0, groups=1):
        w = self.w(f"{p}.weight_orig")
        sigma = self.w(f"{p}.weight_u") @ (w.reshape(w.shape[0], -1) @ self.w(f"{p}.weight_v"))
        return F.conv2d(x, w / sigma, self.sd.get(f"{p}.bias"), stride, padding, 1, groups)

    def layer_norm(self, p, x, eps, names=("weight", "bias")):
        return F.layer_norm(x, (x.shape[-1],), self.w(f"{p}.{names[0]}"),
                            self.w(f"{p}.{names[1]}"), eps)

    def ada_layer_norm(self, p, x, s, eps=1e-5):
        gamma, beta = self.linear(f"{p}.fc", s).chunk(2, dim=-1)
        return (1.0 + gamma[:, None, :]) * F.layer_norm(x, (x.shape[-1],), eps=eps) + beta[:, None, :]

    def adain(self, p, x, s):
        gamma, beta = self.linear(f"{p}.fc", s).chunk(2, dim=-1)
        return (1.0 + gamma[:, :, None]) * instance_norm(x) + beta[:, :, None]

    def lstm(self, p, x, lengths=None):
        """Bidirectional one-layer LSTM over (B, T, C) with the packed
        semantics: padded steps give 0, the reverse direction starts at each
        row's last valid step. Every call is packed (cuDNN's f32 path)."""
        mod = self._lstms.get(p)
        if mod is None:
            i = self.w(f"{p}.weight_ih_l0")
            mod = nn.LSTM(i.shape[1], i.shape[0] // 4, batch_first=True, bidirectional=True,
                          device="meta")
            for name in [n for n, _ in mod.named_parameters()]:
                setattr(mod, name, nn.Parameter(self.w(f"{p}.{name}"), requires_grad=False))
            mod.flatten_parameters() if self.device.type == "cuda" else None
            self._lstms[p] = mod
        B, T = x.shape[:2]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int64)
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
        return pad_packed_sequence(mod(packed)[0], batch_first=True, total_length=T)[0]

    def adain_resblk(self, p, x, s, upsample=False):
        h = leaky(self.adain(f"{p}.norm1", x, s))
        if upsample:
            h = self.wnconv_t(f"{p}.pool", h, 2, 1, 1, groups=h.shape[1])
        h = self.wnconv(f"{p}.conv1", h, padding=1)
        h = leaky(self.adain(f"{p}.norm2", h, s))
        h = self.wnconv(f"{p}.conv2", h, padding=1)
        sc = torch.repeat_interleave(x, 2, dim=-1) if upsample else x
        if f"{p}.conv1x1.weight_v" in self.sd:
            sc = self.wnconv(f"{p}.conv1x1", sc)
        return (h + sc) / math.sqrt(2.0)

    def snake_resblock(self, p, x, s, k, dilations):
        for j, d in enumerate(dilations):
            a1 = self.w(f"{p}.alpha1.{j}").reshape(-1)
            a2 = self.w(f"{p}.alpha2.{j}").reshape(-1)
            g1, b1 = self.linear(f"{p}.adain1.{j}.fc", s).chunk(2, dim=-1)
            g2, b2 = self.linear(f"{p}.adain2.{j}.fc", s).chunk(2, dim=-1)
            if self.k1_sites is not None:
                self.k1_sites.append((x.shape[1], x.shape[2]))
            h = self.wnconv(f"{p}.convs1.{j}", adain_snake(x, g1, b1, a1),
                            padding=(k - 1) * d // 2, dilation=d)
            if self.k1_sites is not None:
                self.k1_sites.append((h.shape[1], h.shape[2]))
            h = self.wnconv(f"{p}.convs2.{j}", adain_snake(h, g2, b2, a2), padding=(k - 1) // 2)
            x = x + h
        return x

    # -- text, style and durations -----------------------------------------
    def text_encoder(self, tokens, lengths):
        T = tokens.shape[1]
        valid = (torch.arange(T, device=tokens.device)[None, :] < lengths.to(tokens.device)[:, None])
        x = F.embedding(tokens, self.w("text_encoder.embedding.weight")).transpose(1, 2)
        x = x.masked_fill(~valid[:, None, :], 0.0)
        for i in range(self.mp["n_layer"]):
            x = self.wnconv(f"text_encoder.cnn.{i}.0", x, padding=2)
            x = self.layer_norm(f"text_encoder.cnn.{i}.1", x.transpose(1, 2), 1e-5,
                                ("gamma", "beta")).transpose(1, 2)
            x = leaky(x).masked_fill(~valid[:, None, :], 0.0)
        x = self.lstm("text_encoder.lstm", x.transpose(1, 2), lengths).transpose(1, 2)
        return x.masked_fill(~valid[:, None, :], 0.0)

    def bert(self, tokens, valid):
        pb = self.pb
        T = tokens.shape[1]
        e = "bert.embeddings"
        emb = (F.embedding(tokens, self.w(f"{e}.word_embeddings.weight"))
               + self.w(f"{e}.position_embeddings.weight")[None, :T]
               + self.w(f"{e}.token_type_embeddings.weight")[0])
        h = self.linear("bert.encoder.embedding_hidden_mapping_in",
                        self.layer_norm(f"{e}.LayerNorm", emb, 1e-12))
        bias = (1.0 - valid.to(h.dtype))[:, None, None, :] * -1e9
        lay = "bert.encoder.albert_layer_groups.0.albert_layers.0"
        B, nh = h.shape[0], pb["num_attention_heads"]
        dh = h.shape[-1] // nh
        for _ in range(pb["num_hidden_layers"]):
            q, k, v = (self.linear(f"{lay}.attention.{n}", h).view(B, T, nh, dh).transpose(1, 2)
                       for n in ("query", "key", "value"))
            att = (q @ k.transpose(-1, -2) / math.sqrt(dh) + bias).softmax(dim=-1)
            ctx = (att @ v).transpose(1, 2).reshape(B, T, -1)
            h = self.layer_norm(f"{lay}.attention.LayerNorm",
                                h + self.linear(f"{lay}.attention.dense", ctx), 1e-12)
            f = self.linear(f"{lay}.ffn_output",
                            F.gelu(self.linear(f"{lay}.ffn", h), approximate="tanh"))
            h = self.layer_norm(f"{lay}.full_layer_layer_norm", h + f, 1e-12)
        return h

    def _denoiser_run(self, x, time, emb, feats, valid):
        d = "diffusion"
        T, ch = emb.shape[1], x.shape[-1]
        freqs = time[:, None] * self.w(f"{d}.to_time.0.0.weights")[None, :] * 2.0 * math.pi
        items = F.gelu(self.linear(f"{d}.to_time.0.1",
                                   torch.cat([time[:, None], freqs.sin(), freqs.cos()], dim=-1)))
        if feats is not None:
            items = items + F.gelu(self.linear(f"{d}.to_features.0", feats))
        mapping = F.gelu(self.linear(f"{d}.to_mapping.2",
                                     F.gelu(self.linear(f"{d}.to_mapping.0", items))))
        h = torch.cat([x.expand(-1, T, ch), emb], dim=-1)
        tr = self.mp["diffusion"]["transformer"]
        nh, dh = tr["num_heads"], tr["head_features"]
        B = h.shape[0]
        for b in range(tr["num_layers"]):
            p = f"{d}.blocks.{b}"
            h = h + mapping[:, None, :]
            if feats is None:
                hq = self.layer_norm(f"{p}.attention.norm", h, 1e-6)
                hk = self.layer_norm(f"{p}.attention.norm_context", h, 1e-6)
            else:
                hq = self.ada_layer_norm(f"{p}.attention.norm", h, feats)
                hk = self.ada_layer_norm(f"{p}.attention.norm_context", h, feats)
            q = self.linear(f"{p}.attention.to_q", hq, bias=False).view(B, T, nh, dh).transpose(1, 2)
            k, v = self.linear(f"{p}.attention.to_kv", hk, bias=False).chunk(2, dim=-1)
            k = k.reshape(B, T, nh, dh).transpose(1, 2)
            v = v.reshape(B, T, nh, dh).transpose(1, 2)
            logits = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
            logits = logits.masked_fill(valid[:, None, None, :] <= 0, torch.finfo(logits.dtype).min)
            out = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, T, nh * dh)
            h = self.linear(f"{p}.attention.attention.to_out", out) + h
            h = self.linear(f"{p}.feed_forward.2",
                            F.gelu(self.linear(f"{p}.feed_forward.0", h))) + h
        h = (h * valid[..., None]).sum(dim=1, keepdim=True) / (valid.sum(dim=1)[:, None, None] + 1e-8)
        w = self.w(f"{d}.to_out.1.weight")
        return F.linear(h, w[:, :, 0], self.w(f"{d}.to_out.1.bias"))

    def denoiser(self, x, time, emb, lengths, feats, scale):
        B, T = emb.shape[:2]
        valid = (torch.arange(T, device=emb.device)[None, :]
                 < lengths.to(emb.device)[:, None]).to(emb.dtype)
        if scale == 1.0:
            return self._denoiser_run(x, time, emb, feats, valid)
        fixed = self.w("diffusion.fixed_embedding.embedding.weight")[None, :T].expand(B, T, -1)
        out2 = self._denoiser_run(torch.cat([x, x]), torch.cat([time, time]),
                                  torch.cat([emb, fixed]),
                                  None if feats is None else torch.cat([feats, feats]),
                                  torch.cat([valid, valid]))
        out, uncond = out2[:B], out2[B:]
        return uncond + (out - uncond) * scale

    def sample_style(self, noise, bert_dur, lengths, feats, steps, scale, generator, sigma_data):
        """ADPM2 over the Karras schedule with EDM preconditioning."""

        def denoise(x, sigma):
            s = torch.full((x.shape[0],), float(sigma), device=x.device)
            c_noise = torch.log(s) * 0.25
            s3 = s[:, None, None]
            d2 = sigma_data ** 2
            c_skip = d2 / (s3 * s3 + d2)
            c_out = s3 * sigma_data * torch.rsqrt(d2 + s3 * s3)
            c_in = torch.rsqrt(s3 * s3 + d2)
            return c_skip * x + c_out * self.denoiser(c_in * x, c_noise, bert_dur, lengths,
                                                      feats, scale)

        sig = karras_sigmas(steps)
        x = noise * float(sig[0])
        for i in range(steps - 1):
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            s0, s1 = sig[i], sig[i + 1]
            up = np.sqrt(max(s1 * s1 * (s0 * s0 - s1 * s1) / (s0 * s0), 0.0))
            down = np.sqrt(max(s1 * s1 - up * up, 0.0))
            smid = (s0 + down) / 2.0
            dd = (x - denoise(x, s0)) / float(s0)
            xm = x + dd * float(smid - s0)
            dm = (xm - denoise(xm, smid)) / float(smid)
            x = x + dm * float(down - s0) + eps * float(up)
        return x

    def durations(self, d_en, s, lengths):
        """The prosody predictor's text encoding d (B, T, H + style) and the
        unrounded durations (B, T)."""
        B, T, _ = d_en.shape
        valid = (torch.arange(T, device=d_en.device)[None, :]
                 < lengths.to(d_en.device)[:, None])[..., None]
        s_seq = s[:, None, :].expand(B, T, s.shape[-1])
        x = torch.cat([d_en, s_seq], dim=-1).masked_fill(~valid, 0.0)
        for j in range(self.mp["n_layer"]):
            h = self.lstm(f"predictor.text_encoder.lstms.{2 * j}", x, lengths)
            h = self.ada_layer_norm(f"predictor.text_encoder.lstms.{2 * j + 1}", h, s)
            x = torch.cat([h, s_seq], dim=-1).masked_fill(~valid, 0.0)
        logits = self.linear("predictor.duration_proj.linear_layer",
                             self.lstm("predictor.lstm", x, lengths))
        return x, torch.sigmoid(logits).sum(dim=-1)

    def phase_a(self, tokens, lengths, noise, feats, alpha, beta, steps, scale, generator,
                sigma_data):
        """-> t_en, d, s (prosodic style), ref (acoustic style), unrounded durations."""
        valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                 < lengths.to(tokens.device)[:, None])
        t_en = self.text_encoder(tokens, lengths)
        bert_dur = self.bert(tokens, valid.to(torch.int32))
        d_en = self.linear("bert_encoder", bert_dur)
        sp = self.sample_style(noise, bert_dur, lengths, feats if self.multispeaker else None,
                               steps, scale, generator, sigma_data)[:, 0, :]
        sd = self.sdim
        ref, s = sp[:, :sd], sp[:, sd:]
        if self.multispeaker:
            ref = alpha * ref + (1.0 - alpha) * feats[:, :sd]
            s = beta * s + (1.0 - beta) * feats[:, sd:]
        d, dur = self.durations(d_en, s, lengths)
        return t_en, d, s, ref, torch.where(valid, dur, torch.zeros_like(dur))

    # -- prosody and the decoder --------------------------------------------
    def prosody(self, t_en, d, s, pred_dur, n_frames):
        cs = torch.cumsum(pred_dur, dim=-1)
        t = torch.arange(n_frames, device=pred_dur.device)[None, None, :]
        aln = ((t >= (cs - pred_dur)[..., None]) & (t < cs[..., None])).to(torch.float32)
        en = torch.einsum("btc,btf->bcf", d, aln)
        asr = torch.einsum("bct,btf->bcf", t_en, aln)
        if self.hifigan:
            en = torch.cat([en[..., :1], en[..., :-1]], dim=-1)
            asr = torch.cat([asr[..., :1], asr[..., :-1]], dim=-1)
        h = self.lstm("predictor.shared", en.transpose(1, 2)).transpose(1, 2)
        out = []
        for br in ("F0", "N"):
            x = h
            for i in range(3):
                x = self.adain_resblk(f"predictor.{br}.{i}", x, s, upsample=(i == 1))
            w = self.w(f"predictor.{br}_proj.weight")
            out.append(F.conv1d(x, w, self.w(f"predictor.{br}_proj.bias"))[:, 0])
        return asr, out[0], out[1]

    def _source(self, f0, generator, upsample_scale):
        """The NSF harmonic source: f0 (B, L, 1) -> tanh(Linear(sines + noise)) (B, L)."""
        B, L, _ = f0.shape
        harmonics = torch.arange(1, 10, device=f0.device, dtype=torch.float32)
        rad = torch.remainder(f0 * harmonics / 24000, 1.0)
        rand_ini = torch.rand((B, 9), generator=generator, device=f0.device)
        rand_ini[:, 0] = 0.0
        rad[:, 0, :] += rand_ini
        rad_frame = _interp(rad, L // upsample_scale)
        phase = torch.cumsum(rad_frame, dim=1) * 2.0 * np.pi
        sines = torch.sin(_interp(phase * upsample_scale, L))
        uv = (f0 > 10.0).float()
        noise_amp = uv * 0.003 + (1.0 - uv) * 0.1 / 3.0
        noise = noise_amp * torch.randn(sines.shape, generator=generator, device=f0.device)
        return torch.tanh(self.linear("decoder.generator.m_source.l_linear",
                                      sines * 0.1 * uv + noise))[..., 0]

    def decode(self, asr, f0_curve, n_curve, s, generator):
        """The decoder's AdaIN head and Generator -> waveforms (B, F * 600)."""
        F0 = self.wnconv("decoder.F0_conv", f0_curve[:, None], stride=2, padding=1)
        N = self.wnconv("decoder.N_conv", n_curve[:, None], stride=2, padding=1)
        x = self.adain_resblk("decoder.encode", torch.cat([asr, F0, N], dim=1), s)
        asr_res = self.wnconv("decoder.asr_res.0", asr)
        for i in range(4):
            x = self.adain_resblk(f"decoder.decode.{i}", torch.cat([x, asr_res, F0, N], dim=1), s,
                                  upsample=(i == 3))
        return self._generator(x, s, f0_curve, generator)

    def _generator(self, x, s, f0_curve, generator):
        dec, gp = self.dec, "decoder.generator"
        rates, kernels = dec["upsample_rates"], dec["upsample_kernel_sizes"]
        nk = len(dec["resblock_kernel_sizes"])
        if self.hifigan:
            total = int(np.prod(rates))
        else:
            total = int(np.prod(rates)) * dec["gen_istft_hop_size"]
            n_fft, hop = dec["gen_istft_n_fft"], dec["gen_istft_hop_size"]
        f0 = torch.repeat_interleave(f0_curve, total, dim=-1)[..., None]
        src = self._source(f0, generator, total)
        if self.hifigan:
            har = src[:, None, :]
        else:
            spec = _stft(src, n_fft, hop, n_fft)
            har = torch.cat([spec.abs(), spec.angle()], dim=1)
        for i, (u, k) in enumerate(zip(rates, kernels)):
            if self.hifigan:
                x = snake(x, self.w(f"{gp}.alphas.{i}"))
                xs = self._noise_branch(i, har, s, len(rates))
                x = self.wnconv_t(f"{gp}.ups.{i}", x, u, u // 2 + u % 2, u % 2) + xs
            else:
                x = leaky(x, 0.1)
                xs = self._noise_branch(i, har, s, len(rates))
                x = self.wnconv_t(f"{gp}.ups.{i}", x, u, (k - u) // 2, 0)
                if i == len(rates) - 1:
                    x = torch.cat([x[:, :, 1:2], x], dim=-1)
                x = x + xs
            acc = None
            for j in range(nk):
                y = self.snake_resblock(f"{gp}.resblocks.{i * nk + j}", x, s,
                                        dec["resblock_kernel_sizes"][j],
                                        dec["resblock_dilation_sizes"][j])
                acc = y if acc is None else acc + y
            x = acc / nk
        if self.hifigan:
            x = snake(x, self.w(f"{gp}.alphas.{len(rates)}"))
            return torch.tanh(self.wnconv(f"{gp}.conv_post", x, padding=3))[:, 0]
        x = self.wnconv(f"{gp}.conv_post", leaky(x), padding=3)
        half = n_fft // 2 + 1
        return _istft(torch.exp(x[:, :half]), torch.sin(x[:, half:]), n_fft, hop, n_fft)

    def _noise_branch(self, i, har, s, n_up):
        gp, rates = "decoder.generator", self.dec["upsample_rates"]
        if i + 1 < n_up:
            stride = int(np.prod(rates[i + 1:]))
            h = F.conv1d(har, self.w(f"{gp}.noise_convs.{i}.weight"),
                         self.w(f"{gp}.noise_convs.{i}.bias"), stride, (stride + 1) // 2)
            k = 7
        else:
            h = F.conv1d(har, self.w(f"{gp}.noise_convs.{i}.weight"),
                         self.w(f"{gp}.noise_convs.{i}.bias"))
            k = 11
        return self.snake_resblock(f"{gp}.noise_res.{i}", h, s, k, (1, 3, 5))

    # -- the mel style encoders ---------------------------------------------
    def style(self, wave):
        """24 kHz wave (T,) -> [acoustic | prosodic] style (1, 2 * style_dim)."""
        x = torch.as_tensor(np.asarray(wave, np.float32), device=self.device)[None]
        spec = _stft(x, 2048, 300, 1200)
        fb = torch.from_numpy(mel_filterbank(1025, 80)).to(self.device)
        mel = torch.einsum("bft,fm->bmt", spec.abs() ** 2, fb)
        mel = (torch.log(1e-5 + mel) + 4.0) / 4.0
        return torch.cat([self._style_encoder("style_encoder", mel),
                          self._style_encoder("predictor_encoder", mel)], dim=-1)

    def _style_encoder(self, enc, mel):
        x = self.snconv(f"{enc}.shared.0", mel[:, None], padding=1)
        for r in range(1, 5):
            p = f"{enc}.shared.{r}"
            h = self.snconv(f"{p}.conv1", leaky(x), padding=1)
            h = self.snconv(f"{p}.downsample_res.conv", h, stride=2, padding=1, groups=h.shape[1])
            h = self.snconv(f"{p}.conv2", leaky(h), padding=1)
            sc = self.snconv(f"{p}.conv1x1", x) if f"{p}.conv1x1.weight_orig" in self.sd else x
            if sc.shape[-1] % 2:
                sc = torch.cat([sc, sc[..., -1:]], dim=-1)
            x = (F.avg_pool2d(sc, 2) + h) / math.sqrt(2.0)
        x = self.snconv(f"{enc}.shared.6", leaky(x)).mean(dim=(2, 3))
        return self.linear(f"{enc}.unshared", leaky(x))


def _interp(x, out_len):
    """Linear interpolation over time of (B, T, C), align_corners=False."""
    T = x.shape[1]
    coords = ((torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5)
              / (out_len / T) - 0.5).clamp(0.0, T - 1.0)
    lo = coords.floor().to(torch.int64)
    hi = (lo + 1).clamp(max=T - 1)
    w = (coords - lo)[None, :, None]
    return x[:, lo, :] * (1.0 - w) + x[:, hi, :] * w


def _stft(x, n_fft, hop, win):
    """Centred, reflect-padded STFT of (B, T) with a Hann window -> (B, n_fft // 2 + 1, F)."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, n_fft, hop) * torch.from_numpy(hann(n_fft, win)).to(x.device)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def _istft(mag, phase, n_fft, hop, win):
    """Overlap-add inverse of `_stft`, normalised by the summed squared window."""
    frames = torch.fft.irfft(torch.polar(mag, phase).transpose(-1, -2), n=n_fft, dim=-1)
    w = hann(n_fft, win)
    frames = frames * torch.from_numpy(w).to(frames.device)
    nF = frames.shape[-2]
    length = n_fft + hop * (nF - 1)
    y = F.fold(frames.transpose(1, 2), (1, length), (1, n_fft), stride=(1, hop))[:, 0, 0, :]
    wsq = np.zeros(length)
    for k in range(n_fft):
        wsq[k: k + hop * nF: hop] += float(w[k]) ** 2
    wsq = np.where(wsq > 1e-11, wsq, 1.0).astype(np.float32)
    y = y / torch.from_numpy(wsq).to(y.device)
    return y[..., n_fft // 2: length - n_fft // 2]
