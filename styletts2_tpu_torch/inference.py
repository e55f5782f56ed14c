"""Synthesis: `Synthesizer.inference(text, ...)`, `inference_fused`, `compute_style`,
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
length); the staged path runs eagerly under `torch.inference_mode()`. The stages
are `torch.profiler.record_function` spans (text, style, duration, prosody,
decode) for the profiler; without one they cost ~1 us.

With `decoder_dtype="bfloat16"` the decode stage alone runs in bf16 (its
weights cast once, its text features and style cast per call) and hands
back an f32 waveform; the decoder keeps its f32 islands (the sine source's
phase, the normalisation statistics, the weight norm, the iSTFT head). The
text, style, duration and prosody stages stay f32, so the durations are
those of the f32 path.

The JAX Synthesizer's single-dispatch paths (`styletts2_tpu/inference.py`):
`inference_fused` runs text, style, duration, the alignment over a fixed
frame budget, prosody and the decoder as one program, and
`Synthesizer(phase_a="fused")` runs `inference`'s text, style and duration
as one program. On a card each program is one CUDA graph (`_Graph`),
captured at its first call for each (text bucket, frame budget, steps,
CFG scale), K1 inside; a call copies its inputs into the graph's buffers,
reseeds the graph's generator and replays it, and copies back the
waveform and its length (phase A: the durations). On the CPU the same
programs run eagerly. Their LSTMs take the lengths on the device
(`layers.masked_lstms`), so nothing in them waits for the host.
"""

from __future__ import annotations

import contextlib
import functools
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.build import build_models
from styletts2_tpu_torch.models.diffusion.sampler import make_denoise_fn, sample_adpm2
from styletts2_tpu_torch.models.layers import masked_lstms
from styletts2_tpu_torch.ops import adain_snake
from styletts2_tpu_torch.ops.stft import preprocess_mel
from styletts2_tpu_torch.text import encode_text, phonemize
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


class _Mix(NamedTuple):
    """The per-call scalars: floats in the staged path, 0-dim tensors of
    one device vector (`_inputs`' "scalars") in the single-dispatch programs, so that
    a graph's call can change them. Each weight pair is computed on the host
    as the staged path's expressions are, so both paths multiply by the
    same f32 values."""
    alpha: Union[float, torch.Tensor]
    alpha_c: Union[float, torch.Tensor]  # 1 - alpha
    beta: Union[float, torch.Tensor]
    beta_c: Union[float, torch.Tensor]  # 1 - beta
    prev: Union[float, torch.Tensor]  # the long-form carry-over's weight
    new: Union[float, torch.Tensor]  # 1 - prev
    speed: Union[float, torch.Tensor]


def _mix(alpha: float, beta: float, prev: float = 0.0, speed: float = 1.0) -> _Mix:
    return _Mix(alpha, 1.0 - alpha, beta, 1.0 - beta, prev, 1.0 - prev, speed)


def _pack(wav: torch.Tensor, total: torch.Tensor, *_) -> torch.Tensor:
    """One utterance's waveform and its length in frames as one f32 vector:
    the single device-to-host copy of `inference_fused`."""
    return torch.cat([wav[0], total.to(wav.dtype)])


class _Graph:
    """A program captured as one CUDA graph on the card of its generator.

    `fn(**static)` runs once eagerly on a side stream (the warm-up builds
    K1 and reads its plans, and makes cuDNN's and cuFFT's plans and the
    STFT caches), then once under capture. The static tensors are the
    graph's inputs, `out` its outputs, both overwritten by the next call.
    The program's draws come from `generator`, registered with the graph: a
    replay after `generator.manual_seed(s)` draws what an eager run from a
    generator seeded s draws, and moves the generator as far. A capture
    that fails raises. `pool` is another graph's memory pool to capture
    into (`graph.pool()`), None for a pool of its own. `capture_s` is the
    warm-up and the capture's wall, `pool_bytes` the memory the capture
    added to the pool, `k1` K1's launches in one replay."""

    def __init__(self, fn: Callable, static: Dict[str, torch.Tensor], generator: torch.Generator,
                 pool=None):
        dev = generator.device
        self.static, self.generator = static, generator
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(**static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with adain_snake.recorded() as k1, torch.cuda.graph(self.graph, pool=pool):
            self.out = fn(**static)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.k1 = k1[0]

    def __call__(self, seed: int, **inputs: torch.Tensor):
        for k, v in inputs.items():
            self.static[k].copy_(v)
        self.generator.manual_seed(seed)
        self.graph.replay()
        adain_snake.replayed(self.k1)
        return self.out


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
    "bfloat16" (see the module's docstring). `phase_a` is "staged" or
    "fused": whether `inference` runs its text, style and duration stages
    one by one or as one program (a CUDA graph on a card; the same numbers
    either way)."""

    def __init__(self, cfg: Config, state_dict=None, seed: int = 0, device="cuda",
                 sigma_data: float = 0.2, decoder_dtype: Optional[str] = None,
                 phase_a: str = "staged"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Synthesizer: device {device}: no CUDA device is available")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if (decoder_dtype or "float32") not in DECODER_DTYPES:
            raise ValueError(f"decoder_dtype {decoder_dtype!r}: one of {sorted(DECODER_DTYPES)}")
        if phase_a not in ("staged", "fused"):
            raise ValueError(f"phase_a {phase_a!r}: 'staged' or 'fused'")
        self.phase_a_mode = phase_a
        self.graphs: Dict[tuple, _Graph] = {}  # captured programs by (kind, T, ...)
        self._generator = None  # the graphs' generator, made at the first capture
        self._lock = threading.Lock()  # a call's replay and its reads of the graph's outputs
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
                  speed: float = 1.0, raw_text: bool = False):
        """Pre-phonemized IPA text (plain text with raw_text) -> (wav float32
        at 24 kHz, s_pred (1, 2*style_dim))."""
        r = self.synthesize(text, ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                            seed, s_prev, s_prev_weight, pad_last_token, trim_samples, speed,
                            raw_text)
        return r.wav, r.s_pred

    def synthesize(self, text: str, ref_s: Optional[np.ndarray] = None,
                   noise: Optional[np.ndarray] = None, alpha: float = 0.3, beta: float = 0.7,
                   diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                   s_prev: Optional[np.ndarray] = None, s_prev_weight: float = 0.0,
                   pad_last_token: Optional[bool] = None, trim_samples: Optional[int] = None,
                   speed: float = 1.0, raw_text: bool = False) -> Synthesis:
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
        from `seed`. raw_text: `text` is plain text, phonemized first
        (`text.phonemize`, espeak-ng; ImportError without it), as the
        reference's inference cells do."""
        if raw_text:
            text = phonemize(text)
        if pad_last_token is None:
            pad_last_token = not self.multispeaker
        if trim_samples is None:
            trim_samples = 50 if self.multispeaker else 0
        tokens = encode_text(text)
        out = self._run([tokens], ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                        seed, s_prev, s_prev_weight, pad_last_token, speed,
                        fused_phase_a=self.phase_a_mode == "fused")
        pred_dur = out.pred_dur[0, : len(tokens)]
        wav = out.wavs[0, : int(pred_dur.sum()) * SAMPLES_PER_FRAME]
        if trim_samples:
            wav = wav[:-trim_samples]
        return Synthesis(wav, out.s_out, pred_dur)

    def inference_fused(self, text: str, frame_budget: int = 600,
                        ref_s: Optional[np.ndarray] = None, alpha: float = 0.3,
                        beta: float = 0.7, diffusion_steps: int = 5,
                        embedding_scale: float = 1.0, seed: int = 0,
                        speed: float = 1.0) -> np.ndarray:
        """Single-dispatch synthesis with a fixed budget of `frame_budget`
        frames (600 samples each): the JAX `inference_fused`. Durations are
        max(round(duration / speed), 1), with no +5 pad; the alignment
        covers the budget, the durations past it cut; the waveform, cut on
        the host to min(sum(durations), budget) * 600 samples, is not
        trimmed. On a card the program is one CUDA graph per (text bucket,
        budget, steps, scale), captured at its first call (`self.graphs`);
        a call makes one device-to-host copy. Its draws: the starting noise
        from `seed + 1`, the churn and the sine source from `seed`."""
        inputs = self._inputs(encode_text(text), ref_s, None, _mix(alpha, beta, speed=speed), seed)
        key = ("fused", inputs["tokens"].shape[1], frame_budget, diffusion_steps,
               float(embedding_scale))

        def program(generator, **program_inputs):
            return _pack(*self._fused(**program_inputs, frame_budget=frame_budget,
                                      steps=diffusion_steps, scale=float(embedding_scale),
                                      generator=generator))

        with torch.inference_mode(), self._lock:
            out = self._dispatch(key, program, inputs, seed)[0].cpu().numpy()
        return out[: int(out[-1]) * SAMPLES_PER_FRAME]

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

    def _inputs(self, tokens: np.ndarray, ref_s, noise, mix: _Mix, seed: int,
                s_prev=None) -> Dict[str, torch.Tensor]:
        """One utterance's inputs to the single-dispatch programs, on the
        device: tokens (1, T) padded to the text bucket, lengths (1,), the
        starting noise (1, 1, 2*style_dim; drawn from seed + 1 unless
        given), the reference style feats (1, 2*style_dim; zeros without
        one), the scalars of `mix` and, with `s_prev`, the carry-over style
        (zeros without one)."""
        dev, sd = self.device, self.style_dim
        T = _bucket(len(tokens), TEXT_BUCKET, TEXT_BUCKET)
        padded = torch.zeros((1, T), dtype=torch.int64)
        padded[0, : len(tokens)] = torch.from_numpy(tokens)
        inputs = {"tokens": padded.to(dev), "lengths": torch.tensor([len(tokens)]).to(dev),
                  "noise": self._noise(noise, 1, seed),
                  "feats": torch.zeros((1, 2 * sd), device=dev) if ref_s is None
                  else _f32(ref_s, 1, 2 * sd).to(dev),
                  "scalars": torch.tensor(list(mix), dtype=torch.float32).to(dev)}
        if s_prev is not None:
            inputs["s_prev"] = s_prev
        return inputs

    def _noise(self, noise, B: int, seed: int) -> torch.Tensor:
        """The diffusion's starting noise (B, 1, 2*style_dim) on the device:
        `noise` as given, else drawn from seed + 1."""
        dev = self.device
        if noise is not None:
            return _f32(noise, B, 1, -1).to(dev)
        return torch.randn((B, 1, 2 * self.style_dim), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed + 1))

    def _dispatch(self, key: tuple, program: Callable, inputs: Dict[str, torch.Tensor],
                  seed: int):
        """`program(generator, **inputs)` for one utterance: on the CPU run
        eagerly with a generator seeded `seed`; on a card replay the CUDA
        graph under `key`, captured at its first use with copies of `inputs`
        as its static inputs, after seeding the graphs' generator. Returns
        (the program's outputs, the generator later draws continue from).
        The graphs share the first one's memory pool: a replay may overwrite
        another graph's outputs, so the caller reads them under `self._lock`
        (which serialises the replays) before releasing it."""
        if self.device.type == "cpu":
            generator = torch.Generator().manual_seed(seed)
            return program(generator, **inputs), generator
        if key not in self.graphs:
            if self._generator is None:
                self._generator = torch.Generator(self.device)
            pool = next(iter(self.graphs.values())).graph.pool() if self.graphs else None
            self.graphs[key] = _Graph(lambda **st: program(self._generator, **st),
                                      {k: v.clone() for k, v in inputs.items()}, self._generator,
                                      pool)
        return self.graphs[key](seed, **inputs), self._generator

    def _phase_a(self, tokens, lengths, valid, noise, feats, mix: _Mix, steps: int,
                 scale: float, generator, s_prev=None):
        """Text, style and duration of a padded batch: tokens (B, T),
        lengths (B,), valid (B, T) int32, noise (B, 1, 2*style_dim), feats
        (B, 2*style_dim) or None (single-speaker) -> (t_en (B, H, T), d
        (B, T, H + style_dim), s, ref (B, style_dim), the unrounded
        durations (B, T))."""
        m, sd = self.models, self.style_dim
        with record_function("text"):
            t_en = m["text_encoder"](tokens, lengths)  # (B, H, T)
            bert_dur = m["bert"](tokens, valid)  # (B, T, 768)
            d_en = m["bert_encoder"](bert_dur)  # (B, T, H)

        def net(x, c_noise):
            return m["diffusion"](x, c_noise, bert_dur, embedding_scale=scale,
                                  embedding_lengths=lengths,
                                  features=feats if self.multispeaker else None)

        with record_function("style"):
            # the sampler's Karras sigmas are host floats: constants of a captured graph
            s_pred = sample_adpm2(make_denoise_fn(net, self.sigma_data), noise, steps,
                                  generator=generator)[:, 0, :]
            if s_prev is not None:  # long-form carry-over
                s_pred = mix.prev * s_prev + mix.new * s_pred
            ref, s = s_pred[:, :sd], s_pred[:, sd:]
            if self.multispeaker:
                ref = mix.alpha * ref + mix.alpha_c * feats[:, :sd]
                s = mix.beta * s + mix.beta_c * feats[:, sd:]

        with record_function("duration"):
            d = m["predictor"].encode_texts(d_en, s, lengths)  # (B, T, H + sd)
            duration = torch.sigmoid(m["predictor"].duration(d, lengths)).sum(dim=-1)
        return t_en, d, s, ref, duration

    def _phase_b(self, t_en, d, s, ref, aln, generator) -> torch.Tensor:
        """Prosody and the decoder over the alignment aln (B, T, F) -> the
        f32 waveforms (B, F * 600)."""
        m = self.models
        with record_function("prosody"):
            en = torch.einsum("btc,btf->bcf", d, aln)
            asr = torch.einsum("bct,btf->bcf", t_en, aln)
            if self.hifigan:  # the reference shifts the HiFi-GAN input one frame right
                en = torch.cat([en[..., :1], en[..., :-1]], dim=-1)
                asr = torch.cat([asr[..., :1], asr[..., :-1]], dim=-1)
            F0, N = m["predictor"].F0Ntrain(en, s)
        with record_function("decode"):
            return decode(m["decoder"], asr, F0, N, ref, generator)

    def _phase_a_program(self, generator, tokens, lengths, noise, feats, scalars, s_prev, *,
                         steps: int, scale: float):
        """Phase A as one program (`phase_a="fused"`; the JAX `_make_phase_a`)
        on the inputs of `_inputs` -> (t_en, d, s, ref, durations (B, T)
        int64, rounded, 0 past each length)."""
        valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
        with masked_lstms():
            t_en, d, s, ref, duration = self._phase_a(
                tokens, lengths, valid.to(torch.int32), noise, feats, _Mix(*scalars.unbind()),
                steps, scale, generator, s_prev)
        pred_dur = torch.clamp(torch.round(duration), min=1.0)
        return t_en, d, s, ref, torch.where(valid, pred_dur, 0.0).to(torch.int64)

    def _fused(self, tokens, lengths, noise, feats, scalars, *, frame_budget: int, steps: int,
               scale: float, generator):
        """The whole pipeline as one program (the JAX `_make_fused`) on the
        inputs of `_inputs` -> (waveforms (B, frame_budget * 600) f32,
        min(sum(durations), frame_budget) (B,), durations (B, T) int64)."""
        mix = _Mix(*scalars.unbind())
        valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
        with masked_lstms():
            t_en, d, s, ref, duration = self._phase_a(
                tokens, lengths, valid.to(torch.int32), noise, feats, mix, steps, scale,
                generator)
            pred_dur = torch.clamp(torch.round(duration / mix.speed), min=1.0)
            pred_dur = torch.where(valid, pred_dur, 0.0).to(torch.int64)
            aln = duration_to_alignment(pred_dur, frame_budget)
            wav = self._phase_b(t_en, d, s, ref, aln, generator)
        return wav, torch.clamp(pred_dur.sum(dim=1), max=frame_budget), pred_dur

    @torch.inference_mode()
    def _run(self, toks: List[np.ndarray], ref_s, noise, alpha, beta, diffusion_steps,
             embedding_scale, seed, s_prev, s_prev_weight, pad_last_token, speed,
             fused_phase_a: bool = False) -> _Batch:
        """Synthesis of a padded batch: phase A staged (each stage on its
        own, the lengths on the host) or, with fused_phase_a (one
        utterance), as one program; the durations rounded on the host;
        prosody and the decoder staged."""
        dev, sd = self.device, self.style_dim
        B, lengths_np = len(toks), np.asarray([len(t) for t in toks])
        mix = _mix(alpha, beta, s_prev_weight if s_prev is not None else 0.0)
        prev = None if s_prev is None else _f32(s_prev, -1, 2 * sd).to(dev)
        with self._lock if fused_phase_a else contextlib.nullcontext():
            if fused_phase_a:  # no carry-over: weight 0 (`mix`) on zeros
                prev = torch.zeros((1, 2 * sd), device=dev) if prev is None else prev
                inputs = self._inputs(toks[0], ref_s, noise, mix, seed, prev)
                program = functools.partial(self._phase_a_program, steps=diffusion_steps,
                                            scale=float(embedding_scale))
                key = ("phase_a", inputs["tokens"].shape[1], diffusion_steps,
                       float(embedding_scale))
                (t_en, d, s, ref, pred_dur), gen = self._dispatch(key, program, inputs, seed)
            else:
                T = _bucket(int(lengths_np.max()), TEXT_BUCKET, TEXT_BUCKET)
                tokens = torch.zeros((B, T), dtype=torch.int64)
                for i, t in enumerate(toks):
                    tokens[i, : len(t)] = torch.from_numpy(t)
                lengths = torch.from_numpy(lengths_np)  # host-side: LSTM packing reads it
                valid = (torch.arange(T)[None, :] < lengths[:, None]).to(torch.int32).to(dev)
                feats = None
                if self.multispeaker:
                    feats = torch.zeros((B, 2 * sd)) if ref_s is None else _f32(ref_s, -1, 2 * sd)
                    feats = feats.expand(B, -1).contiguous().to(dev)
                gen = torch.Generator(dev).manual_seed(seed)
                t_en, d, s, ref, duration = self._phase_a(
                    tokens.to(dev), lengths, valid, self._noise(noise, B, seed), feats, mix,
                    diffusion_steps, embedding_scale, gen, prev)
                pred_dur = torch.clamp(torch.round(duration), min=1.0).to(torch.int64)
            pred_dur = pred_dur.cpu().numpy()
            pred_dur[np.arange(pred_dur.shape[1])[None, :] >= lengths_np[:, None]] = 0
            for i, L in enumerate(lengths_np):
                if speed != 1.0:
                    pred_dur[i, :L] = np.maximum(np.round(pred_dur[i, :L] / speed), 1)
                if pad_last_token:
                    pred_dur[i, L - 1] += 5
            n_frames = _bucket(int(pred_dur.sum(axis=1).max()), FRAME_BUCKET, FRAME_BUCKET)
            aln = duration_to_alignment(torch.from_numpy(pred_dur).to(dev), n_frames)
            wavs = self._phase_b(t_en, d, s, ref, aln, gen).cpu().numpy()
            return _Batch(wavs, torch.cat([ref, s], dim=-1).cpu().numpy(), pred_dur)
