"""Stage-1 training: mel reconstruction, then the transferable monotonic
aligner (TMA) with the GAN and WavLM terms (`styletts2_tpu/train/stage1.py`).

One step: the aligner's soft attention (its sos step dropped, masked to the
valid text x mel region) and its hard monotonic path (host DP), a 50/50
soft / mono choice, clips of a static bucket from random starts, the style
of a clip, and ONE decoder forward to `y_rec`. Before TMA the generator
loss is the unscaled multi-resolution mel loss and the text encoder, style
encoder and decoder are stepped. From TMA on: the discriminators are first
updated on the detached `y_rec`; the generator loss is lambda_mel * mel +
lambda_mono * mono + lambda_s2s * s2s + lambda_slm * WavLM + lambda_gen *
adversarial, the adversarial term taken against the UPDATED discriminators;
the aligner and the pitch extractor are stepped too (the latter gets no
gradient and learns only weight decay, as in the reference). The style
encoder's spectral-norm vectors advance one power iteration per step, stored
after the optimizer step.

The host numpy `rng` draws the soft / mono choice, the clip starts and the
seed of the step's `torch.Generator`, in the JAX trainer's order; the
generator draws the aligner's token mask, the decoder's F0 / N smoothing
and the NSF source's phase and noise. Dropout draws from torch's global
generator. A step's parts run under the profiler ranges `forward`,
`discriminators`, `adversarial`, `backward` and `optimizer`
(`tools/profile_torch_train.py` reads them). With `mixed_precision: bf16`
the step's style encoder, decoder, WavLM and discriminators run in bf16
(`train/mp.py`); validation stays f32, as in the JAX trainer.

As one rank of a data-parallel group (`parallel/ddp.py`) a step computes
the global batch's: the batch padded to the global shapes, the clip length
and the host draws taken over the global batch's lengths (this rank's rows
of them), and the gradients averaged over the ranks before each optimizer
step. The draws of the step's generator and dropout come from each rank's
own stream (`ddp.rank_seed`): the same distributions as one process's, not
its values.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from styletts2_tpu_torch import losses as L
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.models.layers import commit_spectral_updates
from styletts2_tpu_torch.models.wavlm import resample_24k_to_16k
from styletts2_tpu_torch.ops.align import maximum_path
from styletts2_tpu_torch.ops.stft import log_norm, preprocess_mel
from styletts2_tpu_torch.parallel import ddp
from styletts2_tpu_torch.train.mp import casts_once, enabled, run
from styletts2_tpu_torch.train.state import TrainState, step_modules

HOP = 300
GEN_KEYS = ("text_encoder", "style_encoder", "decoder")
TMA_KEYS = ("text_aligner", "pitch_extractor")
D_KEYS = ("msd", "mpd")


def clip_slice(x: torch.Tensor, starts: Sequence[int], length: int) -> torch.Tensor:
    """x (B, ..., T) -> (B, ..., length), item b starting at starts[b]."""
    return torch.stack([x[b, ..., int(s): int(s) + length] for b, s in enumerate(starts)])


def global_rows(batch: Batch):
    """(the batch padded to the global batch's shapes, the global batch's mel
    lengths, this rank's rows of the global batch); one process: (the batch,
    its lengths, all rows)."""
    batch = ddp.pad_batch(batch)
    b = len(batch.mel_lengths)
    return batch, ddp.gather_host(batch.mel_lengths), slice(ddp.rank() * b, (ddp.rank() + 1) * b)


def clip_length(cfg: Config, mel_lengths: np.ndarray) -> Optional[int]:
    """The static clip bucket, in mel-half frames, or None for a batch too
    short to train on: max(bucket, floor_bucket(min(half - 1, max_len // 2)))."""
    half = mel_lengths // 2
    cb = cfg.clip_frame_bucket
    if int(half.min()) - 1 < cb:
        return None
    clip = min(int(half.min()) - 1, cfg.max_len // 2)
    return max(cb, (clip // cb) * cb)


def aligner_pass(aligner: nn.Module, mels, mel_lengths, tokens, input_lengths,
                 generator: Optional[torch.Generator] = None):
    """-> (ctc, s2s_pred, s2s_attn (B, T_text, L), mono (B, T_text, L))."""
    B, T_text = tokens.shape
    L_mem = mels.shape[-1] // 2
    dev = mels.device
    mem_valid = (torch.arange(L_mem, device=dev)[None] < (mel_lengths // 2)[:, None]).float()
    ctc, s2s_pred, attn_all = aligner(mels, mem_valid, tokens, generator)
    text_valid = (torch.arange(T_text, device=dev)[None] < input_lengths[:, None]).float()
    s2s_attn = attn_all[:, 1:] * (text_valid[:, :, None] * mem_valid[:, None, :])
    mono = maximum_path(s2s_attn, input_lengths, mel_lengths // 2)
    return ctc, s2s_pred, s2s_attn, mono


class Stage1Trainer:
    def __init__(self, cfg: Config, state: TrainState, device):
        self.cfg, self.state = cfg, state
        self.models = state.models
        self.device = torch.device(device)
        self.mp = enabled(cfg)

    def _tensors(self, batch: Batch):
        dev = self.device
        return (torch.from_numpy(np.asarray(batch.waves, np.float32)).to(dev),
                torch.from_numpy(np.asarray(batch.tokens)).long().to(dev),
                torch.from_numpy(np.asarray(batch.input_lengths)).long().to(dev),
                torch.from_numpy(np.asarray(batch.mel_lengths)).long().to(dev))

    def forward_recon(self, waves, tokens, input_lengths, mel_lengths, starts, st_starts,
                      clip_len: int, use_mono: bool,
                      generator: Optional[torch.Generator] = None, mp: bool = False):
        """The shared forward to the reconstruction: (y_rec (B, clip * 600),
        the target wave clip, aux); aux["decoder_io"] holds the decoder's
        inputs (en, F0, norm, s), as the JAX trainer's `return_io`. Modules
        run in their current modes; the style encoder and the decoder in bf16
        when `mp` (a training step's)."""
        m = self.models
        mels = preprocess_mel(waves)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        _, s2s_pred, s2s_attn, mono = aligner_pass(m["text_aligner"], mels, mel_lengths, tokens,
                                                   input_lengths, generator)
        t_en = m["text_encoder"](tokens, input_lengths)  # (B, C, T_text)
        asr = t_en @ (mono if use_mono else s2s_attn)  # (B, C, L_mem)
        en = clip_slice(asr, starts, clip_len)
        gt = clip_slice(mels, [2 * s for s in starts], 2 * clip_len)
        wav_clip = clip_slice(waves, [HOP * 2 * s for s in starts], clip_len * 2 * HOP)
        with torch.no_grad():
            real_norm = log_norm(gt)
            f0_real = m["pitch_extractor"](gt)[0]
        style_in = (clip_slice(mels, [2 * s for s in st_starts], 2 * clip_len)
                    if self.cfg.model_params.multispeaker else gt)
        s = run(m, "style_encoder", mp, style_in, update_stats=m["style_encoder"].training)
        y_rec = run(m, "decoder", mp, en, f0_real, real_norm, s, generator)
        return y_rec, wav_clip, {"s2s_pred": s2s_pred, "s2s_attn": s2s_attn, "mono": mono,
                                 "decoder_io": (en, f0_real, real_norm, s)}

    def generator_losses(self, y_rec, wav_clip, aux, tokens, input_lengths, tma: bool):
        """(the generator loss without the adversarial term, metrics)."""
        lp = self.cfg.loss_params
        loss_mel = L.multires_stft_loss(y_rec, wav_clip)
        metrics = {"mel": loss_mel}
        if not tma:
            return loss_mel, metrics  # unscaled before TMA, as the reference
        loss_s2s = L.s2s_ce_loss(aux["s2s_pred"], tokens, input_lengths)
        loss_mono = (aux["s2s_attn"] - aux["mono"]).abs().mean() * 10.0
        m = self.models
        with torch.no_grad():
            real_states = run(m, "wavlm", self.mp, resample_24k_to_16k(wav_clip))
        loss_slm = L.wavlm_feature_loss(real_states,
                                        run(m, "wavlm", self.mp, resample_24k_to_16k(y_rec)))
        metrics.update(s2s=loss_s2s, mono=loss_mono, slm=loss_slm)
        g_loss = (lp.lambda_mel * loss_mel + lp.lambda_mono * loss_mono
                  + lp.lambda_s2s * loss_s2s + lp.lambda_slm * loss_slm)
        return g_loss, metrics

    def _modes(self, train: bool, trainable: Sequence[str]):
        for k, mod in self.models.items():
            mod.train(train and k in GEN_KEYS + ("text_aligner",))
            mod.requires_grad_(k in trainable)

    @casts_once
    def train_step(self, batch: Batch, epoch: int, iters: int,
                   rng: np.random.Generator) -> Optional[Dict[str, float]]:
        """One step (`iters`, the run's step count, is unused: stage 1 has no
        every-n-steps update)."""
        batch, mel_lengths, own = global_rows(batch)
        cfg, m, opts = self.cfg, self.models, self.state.opts
        tma = epoch >= cfg.loss_params.TMA_epoch
        use_mono = bool(rng.integers(0, 2))
        clip_len = clip_length(cfg, mel_lengths)
        if clip_len is None:
            return None  # too short a batch: the reference skips it
        half = mel_lengths // 2
        starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)[own]
        st_starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)[own]
        seed = ddp.rank_seed(int(rng.integers(0, 2 ** 31)))  # this rank's own stream
        gen = torch.Generator(self.device).manual_seed(seed)
        g_keys = GEN_KEYS + (TMA_KEYS if tma else ())
        self._modes(True, g_keys)
        with record_function("forward"):
            waves, tokens, input_lengths, mel_lengths = self._tensors(batch)
            y_rec, wav_clip, aux = self.forward_recon(waves, tokens, input_lengths, mel_lengths,
                                                      starts, st_starts, clip_len, use_mono, gen,
                                                      self.mp)
            g_loss, metrics = self.generator_losses(y_rec, wav_clip, aux, tokens, input_lengths,
                                                    tma)
        if tma:
            # the discriminators first, on the detached reconstruction
            with record_function("discriminators"):
                for k in D_KEYS:
                    m[k].requires_grad_(True)
                y_d = y_rec.detach()
                d_loss = L.discriminator_adv_loss(run(m, "mpd", self.mp, wav_clip, y_d),
                                                  run(m, "msd", self.mp, wav_clip, y_d))
                d_loss.backward()
                ddp.all_reduce_grads(m[k] for k in D_KEYS)
                step_modules(m, opts, D_KEYS)
                for k in D_KEYS:
                    m[k].requires_grad_(False)
            # then the adversarial term against the updated discriminators
            with record_function("adversarial"):
                loss_gen = L.generator_adv_loss(run(m, "mpd", self.mp, wav_clip, y_rec),
                                                run(m, "msd", self.mp, wav_clip, y_rec))
            g_loss = g_loss + cfg.loss_params.lambda_gen * loss_gen
            metrics.update(d_loss=d_loss, gen=loss_gen)
        with record_function("backward"):
            g_loss.backward()
        with record_function("optimizer"):
            ddp.all_reduce_grads(m[k] for k in g_keys)
            step_modules(m, opts, g_keys)
            commit_spectral_updates(m["style_encoder"])
        metrics["g_loss"] = g_loss
        self.state.step += 1
        return {k: float(v.detach()) for k, v in metrics.items()}

    def _eval_recon(self, batch: Batch, rng: np.random.Generator, seed: Optional[int] = None):
        """The eval-mode forward of validation and the artifacts: the mono
        path, the style of the same clip, clip starts from `rng`, the draws
        from `seed` (else a seed drawn from `rng`); None for a batch too
        short to clip."""
        clip_len = clip_length(self.cfg, batch.mel_lengths)
        if clip_len is None:
            return None
        half = batch.mel_lengths // 2
        starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)
        seed = int(rng.integers(0, 2 ** 31)) if seed is None else seed
        self._modes(False, ())
        return self.forward_recon(*self._tensors(batch), starts, starts, clip_len, True,
                                  torch.Generator(self.device).manual_seed(seed))

    @torch.no_grad()
    def validate(self, batch: Batch, rng: np.random.Generator) -> Optional[Dict[str, float]]:
        """The validation mel loss of `_eval_recon`."""
        r = self._eval_recon(batch, rng)
        if r is None:
            return None
        y_rec, wav_clip, _ = r
        return {"mel": float(L.multires_stft_loss(y_rec, wav_clip))}

    @torch.no_grad()
    def eval_artifacts(self, batch: Batch, rng: np.random.Generator) -> Optional[dict]:
        """An epoch's eval artifacts, after the JAX trainer's: `_eval_recon`'s
        reconstructions of the first 3 samples and their ground-truth clips,
        {"audio": {"y_rec_b" / "gt_b": wave}}, and the first sample's soft
        attention over its valid text x mel-half region, "attn"; the
        decoder's draws from seed 0. None for a batch too short to clip."""
        r = self._eval_recon(batch, rng, seed=0)
        if r is None:
            return None
        y_rec, wav_clip, aux = r
        audio = {}
        for b in range(min(3, len(y_rec))):
            audio[f"y_rec_{b}"] = y_rec[b].float().cpu().numpy()
            audio[f"gt_{b}"] = wav_clip[b].cpu().numpy()
        attn = aux["s2s_attn"][0, : int(batch.input_lengths[0]), : int(batch.mel_lengths[0]) // 2]
        return {"audio": audio, "attn": attn.cpu().numpy()}
