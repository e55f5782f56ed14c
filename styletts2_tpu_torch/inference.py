"""Synthesis: `Synthesizer.inference(text, ...)`, `compute_style`,
`inference_batch`, `LFinference`, `STinference` and `long_form`.

The host logic of `styletts2_tpu/inference.py:304-647`: tokens padded to a
text bucket of 64, ADPM2 style diffusion (conditioned on a reference style
and mixed with it when multispeaker), durations rounded on the host (speed
control, +5 frames on the last token for single-speaker), a frame bucket of
100, the decoder (its input shifted one frame right for HiFi-GAN), and each
waveform trimmed to sum(durations) * 600 samples, less 50 when multispeaker.
A batch pads its texts to one text bucket and one frame bucket; per-item
lengths mask the LSTMs and the denoiser, and the decoder's instance norms
see the padded frames, as in the JAX `inference_batch`. The text and frame
buckets stay because they change the numbers (masked padding, the decoded
length); everything runs eagerly under `torch.inference_mode()`. The stages
are `torch.profiler.record_function` spans (text, style, duration, prosody,
decode) for the profiler; without one they cost ~1 us.

With `decoder_dtype="bfloat16"` the decode stage alone runs in bf16 (its
weights cast once, its text features and style cast per call) and hands
back an f32 waveform; the decoder keeps its f32 islands (the sine source's
phase, the normalisation statistics, the weight norm, the iSTFT head). The
text, style, duration and prosody stages stay f32, so the durations are
those of the f32 path.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.build import build_models
from styletts2_tpu_torch.models.diffusion.sampler import make_denoise_fn, sample_adpm2
from styletts2_tpu_torch.ops.stft import preprocess_mel
from styletts2_tpu_torch.text import encode_text
from styletts2_tpu_torch.utils import duration_to_alignment

SAMPLES_PER_FRAME = 600  # 2 mel frames per aligned frame x 300 samples per mel frame
TEXT_BUCKET = 64
FRAME_BUCKET = 100
DECODER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode(decoder: torch.nn.Module, asr: torch.Tensor, F0: torch.Tensor, N: torch.Tensor,
           ref: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The decode stage's call in the dtype of the decoder's weights: the
    aligned text features and the acoustic style cast to it, F0 and N
    handed as they are (the source and the normalisation are f32 islands);
    an f32 waveform back. The fidelity tool's bf16 decodes go through it."""
    dd = next(decoder.parameters()).dtype
    return decoder(asr.to(dd), F0, N, ref.to(dd), generator=generator).float()


def _bucket(n: int, step: int, minimum: int) -> int:
    return max(minimum, ((n + step - 1) // step) * step)


def _f32(x, *shape) -> torch.Tensor:
    """A host array as a float32 tensor of `shape` (a copy)."""
    return torch.from_numpy(np.array(x, np.float32)).reshape(*shape)


class Synthesis(NamedTuple):
    wav: np.ndarray  # float32 at 24 kHz, sum(pred_dur) * 600 - trim_samples samples
    s_pred: np.ndarray  # (1, 2 * style_dim): [acoustic | prosodic] style
    pred_dur: np.ndarray  # (L,) int frames per token, after speed and any +5 pad


class _Batch(NamedTuple):
    wavs: np.ndarray  # (B, n_frames * 600) float32, untrimmed
    s_out: np.ndarray  # (B, 2 * style_dim)
    pred_dur: np.ndarray  # (B, T) int64, 0 past each item's length


class Synthesizer:
    """Holds the synthesis modules on `device` and runs the reference
    inference API (single- or multispeaker, as `cfg` says).

    `state_dict` is the port's layout (`convert.state_dict_from_jax`); without
    it the weights are random, drawn from `seed`. The modules run on the card
    unless the caller asks for the CPU (`device="cpu"`); a CUDA device that
    is not there is an error, never a fall-back to the CPU. `sigma_data` is
    the EDM data scale the style sampler denoises with (a stage-2
    checkpoint's estimate); `decoder_dtype` is "float32" (None) or
    "bfloat16" (see the module's docstring)."""

    def __init__(self, cfg: Config, state_dict=None, seed: int = 0, device="cuda",
                 sigma_data: float = 0.2, decoder_dtype: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Synthesizer: device {device}: no CUDA device is available")
        if (decoder_dtype or "float32") not in DECODER_DTYPES:
            raise ValueError(f"decoder_dtype {decoder_dtype!r}: one of {sorted(DECODER_DTYPES)}")
        self.sigma_data = float(sigma_data)
        self.decoder_dtype = DECODER_DTYPES[decoder_dtype or "float32"]
        mp = cfg.model_params
        self.style_dim = mp.style_dim
        self.multispeaker = mp.multispeaker
        self.hifigan = mp.decoder.type == "hifigan"
        models = build_models(cfg, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            models.load_state_dict(state_dict)
        self.models = models.requires_grad_(False).eval().to(self.device)
        self.models["decoder"].to(self.decoder_dtype)

    @torch.inference_mode()
    def compute_style(self, wave: np.ndarray) -> np.ndarray:
        """24 kHz reference wave (T,) -> (1, 2 * style_dim) [acoustic |
        prosodic] style; T must give at least 80 mel frames (~1 s)."""
        if not self.multispeaker:
            raise ValueError("compute_style needs a multispeaker config")
        w = _f32(wave, 1, -1).to(self.device)
        mel = preprocess_mel(w)
        ref = torch.cat([self.models["style_encoder"](mel),
                         self.models["predictor_encoder"](mel)], dim=-1)
        return ref.cpu().numpy()

    def inference(self, text: str, ref_s: Optional[np.ndarray] = None,
                  noise: Optional[np.ndarray] = None, alpha: float = 0.3, beta: float = 0.7,
                  diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                  s_prev: Optional[np.ndarray] = None, s_prev_weight: float = 0.0,
                  pad_last_token: Optional[bool] = None, trim_samples: Optional[int] = None,
                  speed: float = 1.0):
        """Pre-phonemized IPA text -> (wav float32 at 24 kHz, s_pred (1, 2*style_dim))."""
        r = self.synthesize(text, ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                            seed, s_prev, s_prev_weight, pad_last_token, trim_samples, speed)
        return r.wav, r.s_pred

    def synthesize(self, text: str, ref_s: Optional[np.ndarray] = None,
                   noise: Optional[np.ndarray] = None, alpha: float = 0.3, beta: float = 0.7,
                   diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                   s_prev: Optional[np.ndarray] = None, s_prev_weight: float = 0.0,
                   pad_last_token: Optional[bool] = None, trim_samples: Optional[int] = None,
                   speed: float = 1.0) -> Synthesis:
        """`inference`, also returning the integer durations.

        ref_s: the reference style (1, 2*style_dim) of `compute_style`
        (multispeaker; zeros without it). The sampled style is mixed with it:
        alpha * sampled + (1 - alpha) * reference for the acoustic half, beta
        likewise for the prosodic half. s_prev, s_prev_weight: the long-form
        carry-over, s_prev_weight * s_prev + (1 - s_prev_weight) * sampled,
        before that mix. pad_last_token adds 5 frames to the last token
        (default: single-speaker only); trim_samples cuts that many samples
        off the end (default: 50 when multispeaker, else 0). `noise` is the
        diffusion's starting noise (2*style_dim values); without it, it is
        drawn from `seed + 1`. The churn and the decoder's sine source draw
        from `seed`."""
        if pad_last_token is None:
            pad_last_token = not self.multispeaker
        if trim_samples is None:
            trim_samples = 50 if self.multispeaker else 0
        tokens = encode_text(text)
        out = self._run([tokens], ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                        seed, s_prev, s_prev_weight, pad_last_token, speed)
        pred_dur = out.pred_dur[0, : len(tokens)]
        wav = out.wavs[0, : int(pred_dur.sum()) * SAMPLES_PER_FRAME]
        if trim_samples:
            wav = wav[:-trim_samples]
        return Synthesis(wav, out.s_out, pred_dur)

    def inference_batch(self, texts: Sequence[str], ref_s: Optional[np.ndarray] = None,
                        alpha: float = 0.3, beta: float = 0.7, diffusion_steps: int = 5,
                        embedding_scale: float = 1.0, seed: int = 0,
                        speed: float = 1.0) -> List[np.ndarray]:
        """Length-masked batched synthesis of len(texts) utterances in one
        pass; ref_s is (1 or B, 2*style_dim). Returns the float32 waveforms,
        each sum(durations) * 600 samples, less 50 when multispeaker."""
        out = self._run([encode_text(t) for t in texts], ref_s, None, alpha, beta,
                        diffusion_steps, embedding_scale, seed, None, 0.0,
                        not self.multispeaker, speed)
        trim = 50 if self.multispeaker else 0
        return [w[: int(d.sum()) * SAMPLES_PER_FRAME - trim]
                for w, d in zip(out.wavs, out.pred_dur)]

    def LFinference(self, text: str, s_prev: Optional[np.ndarray],
                    ref_s: Optional[np.ndarray] = None, alpha: float = 0.3, beta: float = 0.7,
                    t: float = 0.7, diffusion_steps: int = 5, embedding_scale: float = 1.0,
                    seed: int = 0, speed: float = 1.0):
        """Long-form segment with style carry-over: s_prev weighs `t` in the
        sampled style. No +5 pad on the last token (the reference's
        LFinference has none); 100 samples trimmed when multispeaker."""
        return self.inference(
            text, ref_s=ref_s, alpha=alpha, beta=beta, diffusion_steps=diffusion_steps,
            embedding_scale=embedding_scale, seed=seed, s_prev=s_prev,
            s_prev_weight=t if s_prev is not None else 0.0,
            pad_last_token=False, trim_samples=100 if self.multispeaker else 0, speed=speed)

    def STinference(self, text: str, ref_s: np.ndarray, ref_text: str, alpha: float = 0.3,
                    beta: float = 0.7, diffusion_steps: int = 5, embedding_scale: float = 1.0,
                    seed: int = 0) -> np.ndarray:
        """Style transfer. The reference embeds `ref_text` but conditions the
        sampler on `text` alone, so `ref_text` changes nothing; kept for the
        API."""
        return self.inference(text, ref_s=ref_s, alpha=alpha, beta=beta,
                              diffusion_steps=diffusion_steps,
                              embedding_scale=embedding_scale, seed=seed)[0]

    def long_form(self, text: str, ref_s: Optional[np.ndarray] = None, t: float = 0.7,
                  seed: int = 0, **kw) -> np.ndarray:
        """A paragraph split into sentences, each an `LFinference` carrying
        the previous sentence's style, seeds seed, seed + 1, ...; the
        waveforms concatenated."""
        sentences = [s.strip() for s in re.split(r"(?<=[.!?…])\s+", text) if s.strip()]
        s_prev, wavs = None, []
        for i, sent in enumerate(sentences):
            wav, s_prev = self.LFinference(sent, s_prev, ref_s=ref_s, t=t, seed=seed + i, **kw)
            wavs.append(wav)
        return np.concatenate(wavs) if wavs else np.zeros(0, np.float32)

    @torch.inference_mode()
    def _run(self, toks: List[np.ndarray], ref_s, noise, alpha, beta, diffusion_steps,
             embedding_scale, seed, s_prev, s_prev_weight, pad_last_token, speed) -> _Batch:
        m, dev, sd = self.models, self.device, self.style_dim
        B = len(toks)
        lengths_np = np.asarray([len(t) for t in toks])
        T = _bucket(int(lengths_np.max()), TEXT_BUCKET, TEXT_BUCKET)
        tokens = torch.zeros((B, T), dtype=torch.int64)
        for i, t in enumerate(toks):
            tokens[i, : len(t)] = torch.from_numpy(t)
        tokens = tokens.to(dev)
        lengths = torch.from_numpy(lengths_np)  # host-side: LSTM packing reads it
        valid = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
        gen = torch.Generator(dev).manual_seed(seed)
        if noise is None:
            noise = torch.randn((B, 1, 2 * sd), device=dev,
                                generator=torch.Generator(dev).manual_seed(seed + 1))
        else:
            noise = _f32(noise, B, 1, -1).to(dev)
        feats = None
        if self.multispeaker:
            feats = torch.zeros((B, 2 * sd)) if ref_s is None else _f32(ref_s, -1, 2 * sd)
            feats = feats.expand(B, -1).contiguous().to(dev)

        with record_function("text"):
            t_en = m["text_encoder"](tokens, lengths)  # (B, H, T)
            bert_dur = m["bert"](tokens, valid)  # (B, T, 768)
            d_en = m["bert_encoder"](bert_dur)  # (B, T, H)

        def net(x, c_noise):
            return m["diffusion"](x, c_noise, bert_dur, embedding_scale=embedding_scale,
                                  embedding_lengths=lengths, features=feats)

        with record_function("style"):
            s_pred = sample_adpm2(make_denoise_fn(net, self.sigma_data), noise,
                                  diffusion_steps, generator=gen)[:, 0, :]
            if s_prev is not None:  # long-form carry-over
                prev = _f32(s_prev, -1, 2 * sd).to(dev)
                s_pred = s_prev_weight * prev + (1.0 - s_prev_weight) * s_pred
            ref, s = s_pred[:, :sd], s_pred[:, sd:]
            if self.multispeaker:
                ref = alpha * ref + (1.0 - alpha) * feats[:, :sd]
                s = beta * s + (1.0 - beta) * feats[:, sd:]

        with record_function("duration"):  # rounded on the host
            d = m["predictor"].encode_texts(d_en, s, lengths)  # (B, T, H + sd)
            duration = torch.sigmoid(m["predictor"].duration(d, lengths)).sum(dim=-1)
            pred_dur = torch.clamp(torch.round(duration), min=1.0).to(torch.int64).cpu().numpy()
        pred_dur[np.arange(T)[None, :] >= lengths_np[:, None]] = 0
        for i, L in enumerate(lengths_np):
            if speed != 1.0:
                pred_dur[i, :L] = np.maximum(np.round(pred_dur[i, :L] / speed), 1)
            if pad_last_token:
                pred_dur[i, L - 1] += 5
        n_frames = _bucket(int(pred_dur.sum(axis=1).max()), FRAME_BUCKET, FRAME_BUCKET)
        aln = duration_to_alignment(torch.from_numpy(pred_dur).to(dev), n_frames)  # (B, T, F)

        with record_function("prosody"):
            en = torch.einsum("btc,btf->bcf", d, aln)
            asr = torch.einsum("bct,btf->bcf", t_en, aln)
            if self.hifigan:  # the reference shifts the HiFi-GAN input one frame right
                en = torch.cat([en[..., :1], en[..., :-1]], dim=-1)
                asr = torch.cat([asr[..., :1], asr[..., :-1]], dim=-1)
            F0, N = m["predictor"].F0Ntrain(en, s)
        with record_function("decode"):
            wavs = decode(m["decoder"], asr, F0, N, ref, gen).cpu().numpy()
        return _Batch(wavs, torch.cat([ref, s], dim=-1).cpu().numpy(), pred_dur)
