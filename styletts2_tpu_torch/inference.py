"""Single-speaker synthesis: `Synthesizer.inference(text, ...)`.

The host logic of `styletts2_tpu/inference.py:312-407`: tokens padded to a
text bucket of 64, ADPM2 style diffusion, durations rounded on the host
(speed control, +5 frames on the last token), a frame bucket of 100, the
decoder, and the waveform trimmed to sum(durations) * 600 samples. The text
and frame buckets stay because they change the numbers (masked padding, the
decoded length); everything runs eagerly under `torch.inference_mode()`.
The stages are `torch.profiler.record_function` spans (text, style,
duration, prosody, decode) for the profiler; without one they cost ~1 us.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.build import build_models
from styletts2_tpu_torch.models.diffusion.sampler import make_denoise_fn, sample_adpm2
from styletts2_tpu_torch.text import encode_text
from styletts2_tpu_torch.utils import duration_to_alignment

SAMPLES_PER_FRAME = 600  # 2 mel frames per aligned frame x 300 samples per mel frame
TEXT_BUCKET = 64
FRAME_BUCKET = 100
SIGMA_DATA = 0.2  # EDM sigma_data the JAX Synthesizer samples with


def _bucket(n: int, step: int, minimum: int) -> int:
    return max(minimum, ((n + step - 1) // step) * step)


class Synthesis(NamedTuple):
    wav: np.ndarray  # float32 at 24 kHz, sum(pred_dur) * 600 samples
    s_pred: np.ndarray  # (1, 2 * style_dim): [acoustic | prosodic] style
    pred_dur: np.ndarray  # (L,) int frames per token, after speed and the +5 pad


class Synthesizer:
    """Holds the slice's modules on `device` and runs single-speaker synthesis.

    `state_dict` is the port's layout (`convert.state_dict_from_jax`); without
    it the weights are random, drawn from `seed`."""

    def __init__(self, cfg: Config, state_dict=None, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.style_dim = cfg.model_params.style_dim
        models = build_models(cfg, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            models.load_state_dict(state_dict)
        self.models = models.requires_grad_(False).eval().to(self.device)

    def inference(self, text: str, noise: Optional[np.ndarray] = None,
                  diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                  speed: float = 1.0):
        """Pre-phonemized IPA text -> (wav float32 at 24 kHz, s_pred (1, 2*style_dim))."""
        r = self.synthesize(text, noise, diffusion_steps, embedding_scale, seed, speed)
        return r.wav, r.s_pred

    @torch.inference_mode()
    def synthesize(self, text: str, noise: Optional[np.ndarray] = None,
                   diffusion_steps: int = 5, embedding_scale: float = 1.0, seed: int = 0,
                   speed: float = 1.0) -> Synthesis:
        """`inference`, also returning the integer durations. `noise` is the
        diffusion's starting noise (2*style_dim values); without it, it is
        drawn from `seed + 1`. The churn and the decoder's sine source draw
        from `seed`."""
        m, dev, sd = self.models, self.device, self.style_dim
        tokens_np = encode_text(text)
        L = len(tokens_np)
        T = _bucket(L, TEXT_BUCKET, TEXT_BUCKET)
        tokens = torch.zeros((1, T), dtype=torch.int64)
        tokens[0, :L] = torch.from_numpy(tokens_np)
        tokens = tokens.to(dev)
        lengths = torch.tensor([L])  # host-side: LSTM packing reads it
        valid = (torch.arange(T) < L).to(torch.int32)[None].to(dev)
        gen = torch.Generator(dev).manual_seed(seed)
        if noise is None:
            noise = torch.randn((1, 1, 2 * sd), device=dev,
                                generator=torch.Generator(dev).manual_seed(seed + 1))
        else:
            noise = torch.as_tensor(np.asarray(noise, np.float32)).reshape(1, 1, -1).to(dev)

        with record_function("text"):
            t_en = m["text_encoder"](tokens, lengths)  # (1, H, T)
            bert_dur = m["bert"](tokens, valid)  # (1, T, 768)
            d_en = m["bert_encoder"](bert_dur)  # (1, T, H)

        def net(x, c_noise):
            return m["diffusion"](x, c_noise, bert_dur, embedding_scale=embedding_scale,
                                  embedding_lengths=lengths)

        with record_function("style"):
            s_pred = sample_adpm2(make_denoise_fn(net, SIGMA_DATA), noise,
                                  diffusion_steps, generator=gen)[:, 0, :]
        ref, s = s_pred[:, :sd], s_pred[:, sd:]

        with record_function("duration"):  # rounded on the host
            d = m["predictor"].encode_texts(d_en, s, lengths)  # (1, T, H + sd)
            duration = torch.sigmoid(m["predictor"].duration(d, lengths)).sum(dim=-1)
            pred_dur = torch.clamp(torch.round(duration), min=1.0)[0, :L]
            pred_dur = pred_dur.to(torch.int64).cpu().numpy()
        if speed != 1.0:
            pred_dur = np.maximum(np.round(pred_dur / speed), 1).astype(np.int64)
        pred_dur[L - 1] += 5
        total = int(pred_dur.sum())
        n_frames = _bucket(total, FRAME_BUCKET, FRAME_BUCKET)
        dur_full = torch.zeros((1, T), dtype=torch.int64)
        dur_full[0, :L] = torch.from_numpy(pred_dur)
        aln = duration_to_alignment(dur_full.to(dev), n_frames)  # (1, T, F)

        with record_function("prosody"):
            en = torch.einsum("btc,btf->bcf", d, aln)
            F0, N = m["predictor"].F0Ntrain(en, s)
            asr = torch.einsum("bct,btf->bcf", t_en, aln)
        with record_function("decode"):
            wav = m["decoder"](asr, F0, N, ref, generator=gen)
            wav = wav[0, : total * SAMPLES_PER_FRAME].cpu().numpy()
        return Synthesis(wav, s_pred.cpu().numpy(), pred_dur)
