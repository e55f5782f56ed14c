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
length).

The JAX Synthesizer's programs, with its boundaries, each a method on
device tensors: `_text` (tokens -> t_en, bert_dur, d_en), `_style` (the
sampled style, the long-form carry-over and the reference mix), `_duration`
(the rounded durations, 0 past each length), `_phase_a_program` (the three
as one program), `_prosody` (the alignment built from the durations, F0 and
energy) and `_decode` (the waveform, or 16-bit PCM); `_fused` is the whole
pipeline over a fixed frame budget. `inference` chains text -> style ->
duration (`phase_a="staged"`) or phase A (`phase_a="fused"`);
`inference_batch` always runs phase A; then the durations come to the host
(speed, +5 pad, frame bucket) and prosody -> decode follow: two host syncs
per request, the durations and the waveform. On a card each program is one
CUDA graph (`_Graph`), captured at its first call for each key (batch, text
bucket, frame bucket, steps, CFG scale, as the JAX jit cache keys them), K1
inside; a call copies its inputs into the graph's buffers and replays it.
The graphs' generator is seeded once per request, so the chained replays
draw what the chained programs draw when run eagerly with one generator. On
the CPU the same programs run eagerly. Their LSTMs take the lengths on the
device (`layers.masked_lstms`), so nothing in them waits for the host. The
replays are `torch.profiler.record_function` spans (text, style, duration,
phase_a, prosody, decode); without a profiler they cost ~1 us.

With `decoder_dtype="bfloat16"` the decode program alone runs in bf16 (its
weights cast once, its text features and style cast per call) and hands
back an f32 waveform; the decoder keeps its f32 islands (the sine source's
phase, the normalisation statistics, the weight norm, the iSTFT head). The
other programs stay f32, so the durations are those of the f32 path.
"""

from __future__ import annotations

import functools
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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
PCM16_SCALE = 32767.0


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
    """The per-call scalars, as 0-dim tensors of one device vector (the
    programs' "scalars" input), so that a graph's call can change them. Each
    weight pair is computed on the host, so every path multiplies by the
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


def _valid(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T) bool: the tokens within each length."""
    return torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]


class _Graph:
    """A program captured as one CUDA graph on the card of its generator.

    `fn(generator, **static)` runs once eagerly on a side stream with a
    generator of its own (the warm-up builds K1 and reads its plans, and
    makes cuDNN's and cuFFT's plans and the STFT caches), then once under
    capture. The static tensors, copies of `inputs` on the card, are the
    graph's inputs; `out`, the graph's outputs, are buffers of their own
    outside the memory pool (the capture ends in copies into them), so no
    other graph's replay reaches them; both are overwritten by the next
    call. The program's draws come from `generator`, registered with the
    graph: a replay draws from the generator's state and moves it as far as
    an eager run would, so replays after one `generator.manual_seed(s)` draw
    what eager runs from one generator seeded s draw. A capture that fails
    raises. `pool` is another graph's memory pool to capture into
    (`graph.pool()`), None for a pool of its own. `capture_s` is the warm-up
    and the capture's wall, `pool_bytes` the memory the capture added to
    the pool, `k1` K1's launches in one replay."""

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor],
                 generator: torch.Generator, pool=None):
        dev = generator.device
        self.generator = generator
        self.static = {k: v.to(dev, copy=True) for k, v in inputs.items()}
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = fn(torch.Generator(dev), **self.static)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.out = tuple(torch.empty_like(w) for w in warm)
        del warm
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with adain_snake.recorded() as k1, torch.cuda.graph(self.graph, pool=pool):
            for o, r in zip(self.out, fn(generator, **self.static)):
                o.copy_(r)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.k1 = k1[0]

    def __call__(self, **inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        for k, v in inputs.items():
            self.static[k].copy_(v)
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
    "fused": whether `inference` runs its text, style and duration programs
    one by one or as one program (the same numbers either way). On a card
    `graphs` holds the captured programs by key; they share one memory
    pool, and `_lock` serialises the requests that replay them."""

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
        self.graphs: Dict[tuple, _Graph] = {}  # captured programs by (kind, B, T, ...)
        self._generator = None  # the graphs' generator, made at the first request
        self._lock = threading.Lock()  # one request's replays and its reads of their outputs
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
                  speed: float = 1.0, raw_text: bool = False, pcm16: bool = False):
        """Pre-phonemized IPA text (plain text with raw_text) -> (wav float32
        at 24 kHz, s_pred (1, 2*style_dim))."""
        r = self.synthesize(text, ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                            seed, s_prev, s_prev_weight, pad_last_token, trim_samples, speed,
                            raw_text, pcm16)
        return r.wav, r.s_pred

    def synthesize(self, text: str, ref_s: Optional[np.ndarray] = None,
                   noise: Optional[np.ndarray] = None, alpha: float = 0.3, beta: float = 0.7,
                   diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                   s_prev: Optional[np.ndarray] = None, s_prev_weight: float = 0.0,
                   pad_last_token: Optional[bool] = None, trim_samples: Optional[int] = None,
                   speed: float = 1.0, raw_text: bool = False, pcm16: bool = False) -> Synthesis:
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
        reference's inference cells do. pcm16: the decode program ends in
        16-bit PCM, clamp(wav * 32767) as int16, and the host divides by
        32767, as the JAX `stage_decode_pcm16` serves."""
        if raw_text:
            text = phonemize(text)
        if pad_last_token is None:
            pad_last_token = not self.multispeaker
        if trim_samples is None:
            trim_samples = 50 if self.multispeaker else 0
        tokens = encode_text(text)
        out = self._run([tokens], ref_s, noise, alpha, beta, diffusion_steps, embedding_scale,
                        seed, s_prev, s_prev_weight, pad_last_token, speed,
                        self.phase_a_mode == "fused", pcm16)
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
            return (_pack(*self._fused(generator, **program_inputs, frame_budget=frame_budget,
                                       steps=diffusion_steps, scale=float(embedding_scale))),)

        with torch.inference_mode(), self._lock:
            (out,) = self._dispatch(key, program, inputs, self._request_generator(seed))
            out = out.cpu().numpy()
        return out[: int(out[-1]) * SAMPLES_PER_FRAME]

    def inference_batch(self, texts: Sequence[str], ref_s: Optional[np.ndarray] = None,
                        alpha: float = 0.3, beta: float = 0.7, diffusion_steps: int = 5,
                        embedding_scale: float = 1.0, seed: int = 0,
                        speed: float = 1.0) -> List[np.ndarray]:
        """Length-masked batched synthesis of len(texts) utterances in one
        pass, phase A as one program (as the JAX `inference_batch`); ref_s is
        (1 or B, 2*style_dim). Returns the float32 waveforms, each
        sum(durations) * 600 samples, less 50 when multispeaker."""
        out = self._run([encode_text(t) for t in texts], ref_s, None, alpha, beta,
                        diffusion_steps, embedding_scale, seed, None, 0.0,
                        not self.multispeaker, speed, True)
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

    # ------------------------------------------------------------------
    # the programs' inputs, their dispatch and the host logic between them

    def _host_inputs(self, toks: List[np.ndarray], ref_s, mix: _Mix,
                     s_prev=None) -> Dict[str, torch.Tensor]:
        """A padded batch's inputs to text, style and phase A, on the host:
        tokens (B, T) padded to one text bucket, lengths (B,), the
        reference style feats (B, 2*style_dim; zeros without one), the
        scalars of `mix` and the carry-over style s_prev (B, 2*style_dim;
        zeros without one, whose weight in `mix` is then 0)."""
        B, sd = len(toks), self.style_dim
        lengths = torch.tensor([len(t) for t in toks])
        tokens = torch.zeros((B, _bucket(int(lengths.max()), TEXT_BUCKET, TEXT_BUCKET)),
                             dtype=torch.int64)
        for i, t in enumerate(toks):
            tokens[i, : len(t)] = torch.from_numpy(t)

        def rows(x):
            return torch.zeros((B, 2 * sd)) if x is None else \
                _f32(x, -1, 2 * sd).expand(B, -1).contiguous()

        return {"tokens": tokens, "lengths": lengths, "feats": rows(ref_s),
                "scalars": torch.tensor(list(mix), dtype=torch.float32), "s_prev": rows(s_prev)}

    def _inputs(self, tokens: np.ndarray, ref_s, noise, mix: _Mix, seed: int,
                s_prev=None) -> Dict[str, torch.Tensor]:
        """One utterance's inputs to the single-dispatch programs, on the
        device: `_host_inputs` of it (s_prev only when given) and the
        starting noise (1, 1, 2*style_dim; drawn from seed + 1 unless
        given)."""
        inputs = self._host_inputs([tokens], ref_s, mix, s_prev)
        if s_prev is None:
            del inputs["s_prev"]
        inputs = {k: v.to(self.device) for k, v in inputs.items()}
        inputs["noise"] = self._noise(noise, 1, seed)
        return inputs

    def _noise(self, noise, B: int, seed: int) -> torch.Tensor:
        """The diffusion's starting noise (B, 1, 2*style_dim) on the device:
        `noise` as given, else drawn from seed + 1."""
        dev = self.device
        if noise is not None:
            return _f32(noise, B, 1, -1).to(dev)
        return torch.randn((B, 1, 2 * self.style_dim), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed + 1))

    def _request_generator(self, seed: int) -> torch.Generator:
        """The generator a request's programs draw from, seeded `seed` once
        per request: on the CPU a new one, on a card the graphs' own."""
        if self.device.type == "cpu":
            return torch.Generator().manual_seed(seed)
        if self._generator is None:
            self._generator = torch.Generator(self.device)
        return self._generator.manual_seed(seed)

    def _dispatch(self, key: tuple, program: Callable, inputs: Dict[str, torch.Tensor],
                  generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        """`program(generator, **inputs)`: on the CPU run eagerly; on a card
        replay the CUDA graph under `key`, captured at its first use into
        the pool of the first graph (inputs may lie on the host or on the
        card). A replay overwrites the outputs of the previous replay of the
        same key, so the caller reads them under `self._lock`."""
        if self.device.type == "cpu":
            return program(generator, **inputs)
        graph = self.graphs.get(key)
        if graph is None:
            pool = next(iter(self.graphs.values())).graph.pool() if self.graphs else None
            graph = self.graphs[key] = _Graph(program, inputs, generator, pool)
        return graph(**inputs)

    @torch.inference_mode()
    def _run(self, toks: List[np.ndarray], ref_s, noise, alpha, beta, diffusion_steps,
             embedding_scale, seed, s_prev, s_prev_weight, pad_last_token, speed,
             fused_phase_a: bool = False, pcm16: bool = False) -> _Batch:
        """Synthesis of a padded batch as the JAX Synthesizer's chain of
        programs: text -> style -> duration, or phase A as one program
        (`fused_phase_a`); the durations and the style to the host (the
        first sync), rounded there for speed, the +5 pad and the frame
        bucket; prosody -> decode; the waveforms to the host (the second)."""
        B, sd = len(toks), self.style_dim
        mix = _mix(alpha, beta, s_prev_weight if s_prev is not None else 0.0)
        host = self._host_inputs(toks, ref_s, mix, s_prev)
        lengths_np = host["lengths"].numpy()
        T, steps, scale = host["tokens"].shape[1], diffusion_steps, float(embedding_scale)
        with self._lock:
            gen = self._request_generator(seed)
            inputs = dict(host, noise=self._noise(noise, B, seed))
            if fused_phase_a:
                with record_function("phase_a"):
                    t_en, d, s, ref, s_out, pred_dur = self._dispatch(
                        ("phase_a", B, T, steps, scale),
                        functools.partial(self._phase_a_program, steps=steps, scale=scale),
                        inputs, gen)
            else:
                with record_function("text"):
                    t_en, bert_dur, d_en = self._dispatch(
                        ("text", B, T), self._text,
                        {k: inputs[k] for k in ("tokens", "lengths")}, gen)
                with record_function("style"):
                    s, ref, s_out = self._dispatch(
                        ("style", B, T, steps, scale),
                        functools.partial(self._style, steps=steps, scale=scale),
                        dict(bert_dur=bert_dur, **{k: inputs[k] for k in (
                            "lengths", "noise", "feats", "scalars", "s_prev")}), gen)
                with record_function("duration"):
                    d, pred_dur = self._dispatch(("duration", B, T), self._duration,
                                                 {"d_en": d_en, "s": s, "lengths": host["lengths"]},
                                                 gen)
            first = torch.cat([pred_dur.to(s_out.dtype), s_out], dim=1).cpu().numpy()
            pred_dur, s_out = first[:, :T].astype(np.int64), first[:, T:]
            for i, L in enumerate(lengths_np):
                if speed != 1.0:
                    pred_dur[i, :L] = np.maximum(np.round(pred_dur[i, :L] / speed), 1)
                if pad_last_token:
                    pred_dur[i, L - 1] += 5
            n_frames = _bucket(int(pred_dur.sum(axis=1).max()), FRAME_BUCKET, FRAME_BUCKET)
            with record_function("prosody"):
                asr, F0, N = self._dispatch(
                    ("prosody", B, T, n_frames),
                    functools.partial(self._prosody, n_frames=n_frames),
                    {"t_en": t_en, "d": d, "s": s, "pred_dur": torch.from_numpy(pred_dur)}, gen)
            with record_function("decode"):
                (wav,) = self._dispatch(("decode", B, n_frames, pcm16),
                                        functools.partial(self._decode, pcm16=pcm16),
                                        {"asr": asr, "F0": F0, "N": N, "ref": ref}, gen)
            wavs = wav.cpu().numpy()
        if pcm16:
            wavs = wavs.astype(np.float32) / PCM16_SCALE
        return _Batch(wavs, s_out, pred_dur)

    # ------------------------------------------------------------------
    # the programs: each on device tensors, the same body on the CPU and,
    # captured, on a card; each returns a tuple

    def _text(self, generator, tokens, lengths):
        """The JAX `stage_text`: tokens (B, T), lengths (B,) -> (t_en (B, H,
        T), bert_dur (B, T, 768), d_en (B, T, H))."""
        m = self.models
        with masked_lstms():
            t_en = m["text_encoder"](tokens, lengths)
        bert_dur = m["bert"](tokens, _valid(tokens, lengths).to(torch.int32))
        return t_en, bert_dur, m["bert_encoder"](bert_dur)

    def _style(self, generator, bert_dur, lengths, noise, feats, scalars, s_prev=None, *,
               steps: int, scale: float):
        """The JAX `stage_style`: the style sampled by `steps` of ADPM2 from
        noise (B, 1, 2*style_dim), conditioned on bert_dur and, multispeaker,
        on the reference feats (B, 2*style_dim), at CFG scale `scale`; with
        s_prev the long-form carry-over; multispeaker, the mix with feats ->
        (s, ref (B, style_dim), s_out = [ref | s])."""
        m, sd, mix = self.models, self.style_dim, _Mix(*scalars.unbind())

        def net(x, c_noise):
            return m["diffusion"](x, c_noise, bert_dur, embedding_scale=scale,
                                  embedding_lengths=lengths,
                                  features=feats if self.multispeaker else None)

        # the sampler's Karras sigmas are host floats: constants of a captured graph
        s_pred = sample_adpm2(make_denoise_fn(net, self.sigma_data), noise, steps,
                              generator=generator)[:, 0, :]
        if s_prev is not None:  # the long-form carry-over
            s_pred = mix.prev * s_prev + mix.new * s_pred
        ref, s = s_pred[:, :sd], s_pred[:, sd:]
        if self.multispeaker:
            ref = mix.alpha * ref + mix.alpha_c * feats[:, :sd]
            s = mix.beta * s + mix.beta_c * feats[:, sd:]
        return s, ref, torch.cat([ref, s], dim=-1)

    def _durations(self, d_en, s, lengths):
        """The predictor's text encoding d (B, T, H + style_dim) and the
        unrounded durations (B, T)."""
        p = self.models["predictor"]
        with masked_lstms():
            d = p.encode_texts(d_en, s, lengths)
            return d, torch.sigmoid(p.duration(d, lengths)).sum(dim=-1)

    def _duration(self, generator, d_en, s, lengths):
        """The JAX `stage_duration` -> (d, durations (B, T) int64:
        max(round(duration), 1), 0 past each length)."""
        d, duration = self._durations(d_en, s, lengths)
        pred_dur = torch.clamp(torch.round(duration), min=1.0)
        return d, torch.where(_valid(d_en, lengths), pred_dur, 0.0).to(torch.int64)

    def _phase_a_program(self, generator, tokens, lengths, noise, feats, scalars, s_prev, *,
                         steps: int, scale: float):
        """Phase A as one program (the JAX `_make_phase_a`): text, style and
        duration -> (t_en, d, s, ref, s_out, durations)."""
        t_en, bert_dur, d_en = self._text(generator, tokens, lengths)
        s, ref, s_out = self._style(generator, bert_dur, lengths, noise, feats, scalars, s_prev,
                                    steps=steps, scale=scale)
        d, pred_dur = self._duration(generator, d_en, s, lengths)
        return t_en, d, s, ref, s_out, pred_dur

    def _prosody(self, generator, t_en, d, s, pred_dur, *, n_frames: int):
        """The JAX `stage_prosody`: the alignment (B, T, n_frames) of the
        durations pred_dur (B, T), the aligned text features (shifted one
        frame right for HiFi-GAN) and F0Ntrain -> (asr (B, H, F), F0, N)."""
        aln = duration_to_alignment(pred_dur, n_frames)
        en = torch.einsum("btc,btf->bcf", d, aln)
        asr = torch.einsum("bct,btf->bcf", t_en, aln)
        if self.hifigan:  # the reference shifts the HiFi-GAN input one frame right
            en = torch.cat([en[..., :1], en[..., :-1]], dim=-1)
            asr = torch.cat([asr[..., :1], asr[..., :-1]], dim=-1)
        F0, N = self.models["predictor"].F0Ntrain(en, s)
        return asr, F0, N

    def _decode(self, generator, asr, F0, N, ref, *, pcm16: bool = False):
        """The JAX `stage_decode` -> (the f32 waveforms (B, F * 600),), or
        `stage_decode_pcm16` -> (int16 clamp(wav * 32767),)."""
        wav = decode(self.models["decoder"], asr, F0, N, ref, generator)
        if pcm16:
            return (torch.clamp(wav * PCM16_SCALE, -32768.0, 32767.0).to(torch.int16),)
        return (wav,)

    def _fused(self, generator, tokens, lengths, noise, feats, scalars, *, frame_budget: int,
               steps: int, scale: float):
        """The whole pipeline as one program (the JAX `_make_fused`) on the
        inputs of `_inputs` -> (waveforms (B, frame_budget * 600) f32,
        min(sum(durations), frame_budget) (B,), durations (B, T) int64)."""
        mix = _Mix(*scalars.unbind())
        t_en, bert_dur, d_en = self._text(generator, tokens, lengths)
        s, ref, _ = self._style(generator, bert_dur, lengths, noise, feats, scalars,
                                steps=steps, scale=scale)
        d, duration = self._durations(d_en, s, lengths)
        pred_dur = torch.clamp(torch.round(duration / mix.speed), min=1.0)
        pred_dur = torch.where(_valid(tokens, lengths), pred_dur, 0.0).to(torch.int64)
        asr, F0, N = self._prosody(generator, t_en, d, s, pred_dur, n_frames=frame_budget)
        (wav,) = self._decode(generator, asr, F0, N, ref)
        return wav, torch.clamp(pred_dur.sum(dim=1), max=frame_budget), pred_dur
