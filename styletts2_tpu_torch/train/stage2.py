"""Stage-2 training: style diffusion, prosody prediction and the
SLM-adversarial pass (`styletts2_tpu/train/stage2.py`); with finetune=True,
finetuning (`styletts2_tpu/train/finetune.py`).

One step, in the JAX trainer's order:
1. `generator_forward`: the aligner's hard monotonic path (without gradient
   and in eval mode, except when finetuning), the full-utterance styles of
   both style encoders (one spectral-norm power iteration each, stored only
   after the step: every other pass of the step sees the vectors it began
   with), PL-BERT -> bert_encoder; from diff_epoch the EDM loss and the L1 of
   a 3- or 4-step sampled style (differentiated through the sampler); the
   prosody predictor with dropout; clips of the static bucket and their
   styles; `y_rec_gt_pred`, decoded from the ground-truth F0 / energy
   without gradient; `y_rec`, decoded from the predicted ones (the decoder's
   box smoothing from joint_epoch); the F0, energy, mel, WavLM-feature and
   duration losses (finetuning adds the aligner's s2s and mono).
2. From diff_epoch (from epoch 0 when finetuning) the discriminators step on
   the detached `y_rec`; the adversarial term is taken against the updated
   ones.
3. The generator's backward and step: bert, bert_encoder, predictor,
   predictor_encoder; diffusion from diff_epoch; style_encoder and decoder
   from joint_epoch (always when finetuning, with text_encoder and
   text_aligner). The spectral-norm vectors are stored; sigma_data becomes
   the batch mean of the full-utterance style's std when estimate_sigma_data.
4. From joint_epoch, with the updated weights, the SLM-adversarial pass
   (`slm_generator_loss`): PL-BERT of the reference (OOD) texts, a sampled
   style, durations made differentiable by `soft_alignment`, a decoded clip
   scored by the WavLM discriminator `wd`; its gradients are divided by the
   predictor's norm above slmadv_params.thresh and those of the duration
   head and the diffusion model scaled by slmadv_params.scale. Every
   slmadv_params.iter steps `wd` steps (`slm_discriminator_loss`).

The host numpy `rng` draws the clip starts, the sampler's step count, the
coins (reference texts from the batch itself, the style from the batch,
the reconstruction regulariser) and the seed of the step's
`torch.Generator`, in `train_step`'s order; the generator draws the EDM
noise, the embedding masks, the sampler's noise and churn, the SLM clip
starts and the decoder's draws; dropout draws from torch's global
generator. A step's parts run under the profiler ranges `forward`,
`discriminators`, `adversarial`, `backward`, `optimizer`, `slm` and `slm_d`.

With `mixed_precision: bf16` the step's style encoders, decoder runs,
WavLM and discriminators compute in bf16 (`train/mp.py`); the styles that
enter the predictor, the diffusion and the losses are upcast to f32, the
acoustic clip style reaches the decoder in bf16, and the WavLM
discriminator's head stays f32. Validation stays f32, as in the JAX trainer.

As one rank of a data-parallel group (`parallel/ddp.py`) a step computes
the global batch's, as stage 1's does (`stage1.global_rows`); the SLM pass
takes the first slm-batch rows of the global batch, gathered from the
ranks and split evenly over them (`_slm_rows`), its loss's sums taken over
the ranks; the predictor's gradient norm is the averaged gradient's, and
the sigma_data estimate the global batch's mean.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from styletts2_tpu_torch import losses as L
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.data.meldataset import Batch
from styletts2_tpu_torch.models.diffusion.denoiser import draw_embedding_mask
from styletts2_tpu_torch.models.diffusion.sampler import (kdiffusion_loss, make_denoise_fn,
                                                          sample_adpm2)
from styletts2_tpu_torch.models.layers import commit_spectral_updates
from styletts2_tpu_torch.models.wavlm import resample_24k_to_16k
from styletts2_tpu_torch.ops.stft import log_norm, preprocess_mel
from styletts2_tpu_torch.parallel import ddp
from styletts2_tpu_torch.train.mp import casts_once, enabled, run
from styletts2_tpu_torch.train.stage1 import (D_KEYS, HOP, aligner_pass, clip_length, clip_slice,
                                              global_rows)
from styletts2_tpu_torch.train.state import TrainState, drop_bias_hh_grads, step_modules
from styletts2_tpu_torch.utils import duration_to_alignment

SAMPLES_PER_FRAME = 2 * HOP  # a predictor frame is two mel frames

SLM_KEYS = ("bert_encoder", "bert", "predictor", "diffusion")
STYLE_KEYS = ("predictor_encoder", "style_encoder")


def soft_alignment(dur_logits: torch.Tensor, lengths: torch.Tensor, n_frames: int,
                   sig: float = 1.5):
    """Differentiable durations -> a soft alignment (B, T, n_frames) and the
    rounded total frames (B,).

    out[b, i, j] = sum over n <= j of logits[b, i, n] * exp(-(loc_i + n - 1
    - j)^2 / 2 sig^2), the Gaussian terms weighted by the raw logits; the
    sigmoid of the logits gives each token's duration, its centre loc_i
    (cumulative duration less half its own) and the total. A softmax over
    the valid tokens, then frames j >= round(total) zeroed. The terms are
    accumulated in n's order, as the JAX scan does."""
    B, T, D = dur_logits.shape
    dev = dur_logits.device
    valid_tok = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).to(dur_logits.dtype)
    dur = (torch.sigmoid(dur_logits) * valid_tok[..., None]).sum(dim=-1)  # (B, T)
    loc = torch.cumsum(dur, dim=1) - dur / 2.0
    total = torch.round(dur.sum(dim=1)).to(torch.int64)
    j = torch.arange(n_frames, device=dev, dtype=dur_logits.dtype)[None, None, :]
    out = torch.zeros((B, T, n_frames), device=dev, dtype=dur_logits.dtype)
    for n in range(D):
        w = torch.exp(-0.5 * (loc[..., None] + float(n) - 1.0 - j) ** 2 / sig ** 2)
        w = torch.where(j >= n, w, 0.0)
        out = out + dur_logits[..., n, None] * w
    out = out.masked_fill(valid_tok[..., None] <= 0, float("-inf"))
    attn = torch.softmax(out, dim=1)
    frame_valid = (torch.arange(n_frames, device=dev)[None, :] < total[:, None])
    return attn * frame_valid[:, None, :].to(attn.dtype), total


class Stage2Trainer:
    def __init__(self, cfg: Config, state: TrainState, device, finetune: bool = False):
        self.cfg, self.state, self.finetune = cfg, state, finetune
        self.models = state.models
        self.device = torch.device(device)
        self.multispeaker = cfg.model_params.multispeaker
        self.mp = enabled(cfg)

    # ------------------------------------------------------------------
    def gen_keys(self, diff_on: bool, joint_on: bool):
        """The modules the generator step updates in this phase."""
        keys = ("bert_encoder", "bert", "predictor", "predictor_encoder")
        if diff_on:
            keys += ("diffusion",)
        if joint_on or self.finetune:
            keys += ("style_encoder", "decoder")
        if self.finetune:
            keys += ("text_encoder", "text_aligner")
        return keys

    def _modes(self, train: bool, trainable=()):
        """Eval mode and no gradient everywhere but: in training the
        predictor (its dropout) and, when finetuning, the aligner (its token
        mask and dropout) run in train mode, and when finetuning the text
        encoder's LSTM too (cuDNN's LSTM backward needs it; a one-layer LSTM
        has no dropout), the rest of the text encoder staying deterministic
        as in the JAX trainer. `trainable` modules take gradients."""
        for k, mod in self.models.items():
            mod.train(train and (k == "predictor" or (self.finetune and k == "text_aligner")))
        self._trainable(trainable)
        if train and self.finetune:
            for mod in self.models["text_encoder"].modules():
                if isinstance(mod, nn.LSTM):
                    mod.train()

    def _trainable(self, keys):
        for k, mod in self.models.items():
            mod.requires_grad_(k in keys)

    def _tensors(self, batch: Batch, use_ind: bool = False) -> Dict[str, torch.Tensor]:
        """The batch on the device; the SLM pass's reference texts are the
        batch's own when `use_ind`, else its OOD texts."""
        def dev(a, dtype=torch.int64):
            return torch.from_numpy(np.asarray(a)).to(dtype).to(self.device)

        ref_mel_lengths = np.minimum(batch.ref_wave_lengths // HOP + 1,
                                     batch.ref_waves.shape[1] // HOP)
        return {
            "waves": dev(batch.waves, torch.float32), "tokens": dev(batch.tokens),
            "input_lengths": dev(batch.input_lengths), "mel_lengths": dev(batch.mel_lengths),
            "ref_tokens": dev(batch.tokens if use_ind else batch.ref_tokens),
            "ref_lengths": dev(batch.input_lengths if use_ind else batch.ref_lengths),
            "ref_waves": dev(batch.ref_waves, torch.float32), "ref_mel_lengths": dev(ref_mel_lengths),
        }

    def slm_frames(self):
        """(clip frames, alignment frames) of the SLM pass."""
        sa = self.cfg.slmadv_params
        clip = sa.min_len // 2
        return clip, max(sa.max_len, 2 * clip + 40)

    def _bert(self, tokens, lengths):
        valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                 < lengths[:, None]).to(torch.int32)
        bert_dur = self.models["bert"](tokens, valid)
        return bert_dur, self.models["bert_encoder"](bert_dur)

    def _sample_style(self, bert_dur, feats, num_steps, sigma_data, mask, generator):
        """A style sampled by `num_steps` of ADPM2, with gradients."""
        def net(x, c_noise):
            return self.models["diffusion"](x, c_noise, bert_dur, features=feats, embedding_mask=mask)

        B, dev = bert_dur.shape[0], bert_dur.device
        noise = torch.randn((B, 1, 2 * self.cfg.model_params.style_dim), generator=generator,
                            device=dev)
        return sample_adpm2(make_denoise_fn(net, sigma_data), noise, num_steps, generator)[:, 0]

    # ------------------------------------------------------------------
    def generator_forward(self, t, starts, st_starts, clip_len: int, diff_on: bool, joint_on: bool,
                          num_steps: int, sigma_data: float,
                          generator: Optional[torch.Generator] = None, train: bool = True):
        """The generator's forward without the adversarial term: (g_loss,
        y_rec (B, clip * 600), metrics, aux). Modules run in their current
        modes but the decoder, which runs in train mode for `y_rec` when
        `train` and joint_on (its box smoothing), else in eval mode."""
        cfg, m, mp = self.cfg, self.models, self.mp
        lp, dist = cfg.loss_params, cfg.model_params.diffusion.dist
        mask_proba = cfg.model_params.diffusion.embedding_mask_proba
        waves, tokens = t["waves"], t["tokens"]
        lengths, mel_lengths = t["input_lengths"], t["mel_lengths"]
        mels = preprocess_mel(waves)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        with contextlib.nullcontext() if self.finetune else torch.no_grad():
            _, s2s_pred, s2s_attn, mono = aligner_pass(m["text_aligner"], mels, mel_lengths, tokens,
                                                       lengths, generator)
            t_en = m["text_encoder"](tokens, lengths)  # (B, C, T_text)
        asr = t_en @ mono  # (B, C, L)
        d_gt = mono.sum(dim=-1)  # (B, T_text)
        # full-utterance styles; their power iterations are stored after the step
        s_dur_full = run(m, "predictor_encoder", mp, mels, lengths=mel_lengths,
                         update_stats=True).float()
        with torch.no_grad():
            gs_full = run(m, "style_encoder", mp, mels, lengths=mel_lengths,
                          update_stats=True).float()
        s_trg = torch.cat([gs_full, s_dur_full.detach()], dim=-1)
        bert_dur, d_en = self._bert(tokens, lengths)
        metrics, feats = {}, None
        loss_diff = loss_sty = 0.0
        if diff_on:
            if self.multispeaker:
                with torch.no_grad():
                    ref_mels = preprocess_mel(t["ref_waves"])
                    feats = torch.cat([run(m, k, mp, ref_mels, lengths=t["ref_mel_lengths"])
                                       for k in ("style_encoder", "predictor_encoder")],
                                      dim=-1).float()
            mask = draw_embedding_mask(len(tokens), mask_proba, generator, tokens.device)
            loss_diff = kdiffusion_loss(
                lambda x, c: m["diffusion"](x, c, bert_dur, features=feats, embedding_mask=mask),
                s_trg[:, None, :], sigma_data, dist.mean, dist.std, generator)
            s_preds = self._sample_style(bert_dur, feats, num_steps, sigma_data, None, generator)
            loss_sty = (s_preds - s_trg).abs().mean()
            metrics.update(diff=loss_diff, sty=loss_sty)

        dur_logits, p_seq = m["predictor"](d_en, s_dur_full, lengths, mono)
        en = clip_slice(asr, starts, clip_len)
        p_en = clip_slice(p_seq, starts, clip_len)
        gt = clip_slice(mels, [2 * s for s in starts], 2 * clip_len)
        wav_clip = clip_slice(waves, [2 * HOP * s for s in starts], clip_len * 2 * HOP)
        style_in = (clip_slice(mels, [2 * s for s in st_starts], 2 * clip_len)
                    if self.multispeaker else gt)
        s_dur_clip = run(m, "predictor_encoder", mp, style_in).float()
        s_clip = run(m, "style_encoder", mp, style_in)  # to the decoder, in its dtype
        dec = m["decoder"].eval()
        with torch.no_grad():
            f0_real = m["pitch_extractor"](gt)[0]
            n_real = log_norm(gt)
            y_rec_gt_pred = run(m, "decoder", mp, en, f0_real, n_real, s_clip, generator)
        wav_tgt = wav_clip if joint_on else y_rec_gt_pred
        f0_fake, n_fake = m["predictor"].F0Ntrain(p_en, s_dur_clip)
        dec.train(train and joint_on)
        y_rec = run(m, "decoder", mp, en, f0_fake, n_fake, s_clip, generator)
        dec.eval()

        loss_f0 = L.smooth_l1(f0_real, f0_fake) / 10.0
        loss_norm = L.smooth_l1(n_real, n_fake)
        loss_mel = L.multires_stft_loss(y_rec, wav_tgt)
        with torch.no_grad():
            real_states = run(m, "wavlm", mp, resample_24k_to_16k(wav_tgt))
        loss_slm = L.wavlm_feature_loss(real_states,
                                        run(m, "wavlm", mp, resample_24k_to_16k(y_rec)))
        loss_ce = L.duration_ce_loss(dur_logits, d_gt, lengths)
        loss_dur = L.duration_l1_loss(torch.sigmoid(dur_logits).sum(dim=-1), d_gt, lengths)
        g_loss = (lp.lambda_mel * loss_mel + lp.lambda_F0 * loss_f0 + lp.lambda_ce * loss_ce
                  + lp.lambda_norm * loss_norm + lp.lambda_dur * loss_dur
                  + lp.lambda_slm * loss_slm + lp.lambda_sty * loss_sty
                  + lp.lambda_diff * loss_diff)
        if self.finetune:
            loss_s2s = L.s2s_ce_loss(s2s_pred, tokens, lengths)
            loss_mono = (s2s_attn - mono).abs().mean() * 10.0
            g_loss = g_loss + lp.lambda_s2s * loss_s2s + lp.lambda_mono * loss_mono
            metrics.update(s2s=loss_s2s, mono=loss_mono)
        metrics.update(mel=loss_mel, F0=loss_f0, ce=loss_ce, norm=loss_norm, dur=loss_dur,
                       slm=loss_slm, g_loss=g_loss)
        aux = {"s_trg": s_trg.detach(), "wav_tgt": wav_tgt.detach(), "y_rec_gt": wav_clip,
               "y_rec_gt_pred": y_rec_gt_pred, "feats": feats}
        return g_loss, y_rec, metrics, aux

    # ------------------------------------------------------------------
    def _slm_rows(self, t, aux):
        """This rank's rows of the SLM pass, the first K (the slm batch) of
        the global batch split evenly over the ranks: {name: its rows} of
        the batch and the step's aux. One process: the first K rows."""
        sa = self.cfg.slmadv_params
        K = max(2, int(len(t["tokens"]) * ddp.world() * sa.batch_percentage))
        n = ddp.local_batch_size(K, ddp.world())
        first = ddp.rank() * n

        def rows(x):
            return None if x is None else ddp.gather_rows(x.detach())[first: first + n]

        out = {k: rows(t[k]) for k in ("ref_tokens", "ref_lengths", "mel_lengths", "waves")}
        out.update({k: rows(aux[k]) for k in ("s_trg", "feats", "y_rec_gt_pred")})
        return out

    def slm_generator_loss(self, t, aux, num_steps: int, use_ind: bool, sigma_data: float,
                           generator: Optional[torch.Generator] = None):
        """The SLM-adversarial generator loss over the first slm batch items
        (this rank's share of them, `_slm_rows`): (loss, y_pred (K, clip *
        600), valid (K,) bool). The style is the batch's own when `use_ind`,
        else sampled from the reference texts' PL-BERT; an item counts when
        its predicted total and its utterance's half length both exceed the
        clip."""
        cfg, m = self.cfg, self.models
        r = self._slm_rows(t, aux)
        slm_clip, slm_frames = self.slm_frames()
        K = len(r["ref_tokens"])
        sd = cfg.model_params.style_dim
        ref_tokens, ref_lengths = r["ref_tokens"], r["ref_lengths"]
        dev = ref_tokens.device
        bert_dur, d_en = self._bert(ref_tokens, ref_lengths)
        if use_ind:
            s_preds = r["s_trg"]
        else:
            feats = r["feats"]
            mask = draw_embedding_mask(K, cfg.model_params.diffusion.embedding_mask_proba,
                                       generator, dev)
            s_preds = self._sample_style(bert_dur, feats, num_steps, sigma_data, mask, generator)
        s_dur, s_ac = s_preds[:, sd:], s_preds[:, :sd]
        # one dropout draw for the encoded texts serves the durations and the
        # aligned features, as the JAX trainer's shared dropout key does
        d = m["predictor"].encode_texts(d_en, s_dur, ref_lengths)
        dur_logits = m["predictor"].duration(d, ref_lengths)
        attn, total = soft_alignment(dur_logits, ref_lengths, slm_frames, cfg.slmadv_params.sig)
        with torch.no_grad():
            t_en = m["text_encoder"](ref_tokens, ref_lengths)
        asr_pred = t_en @ attn  # (K, C, F)
        p_pred = d.transpose(1, 2) @ attn
        gt_half = r["mel_lengths"] // 2
        valid = (total > slm_clip) & (gt_half > slm_clip)
        max_start = torch.clamp(torch.clamp(total, max=slm_frames) - slm_clip, min=1)
        starts = (torch.rand((K,), generator=generator, device=dev) * max_start).long().tolist()
        f0, n = m["predictor"].F0Ntrain(clip_slice(p_pred, starts, slm_clip), s_dur)
        m["decoder"].eval()
        y_pred = run(m, "decoder", self.mp, clip_slice(asr_pred, starts, slm_clip), f0, n, s_ac,
                     generator)
        d_g = m["wd"](L.stack_wavlm_states(run(m, "wavlm", self.mp, resample_24k_to_16k(y_pred))))
        w = valid.float()[:, None]
        loss = ddp.global_sum((((1.0 - d_g) ** 2) * w).sum()) / torch.clamp(
            ddp.global_sum(w.sum()) * d_g.shape[1], min=1.0)
        return loss, y_pred, valid

    def scale_slm_grads(self) -> None:
        """The reference's post-processing of the SLM gradients: all divided
        by the predictor's global norm where it exceeds thresh, then those of
        the duration head (predictor.duration_proj, predictor.lstm) and of
        the diffusion model scaled by `scale`."""
        sa, m = self.cfg.slmadv_params, self.models
        for k in SLM_KEYS:
            drop_bias_hh_grads(m[k])
        grads = [p.grad for p in m["predictor"].parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale_all = torch.where(norm > sa.thresh, 1.0 / torch.clamp(norm, min=1e-8),
                                torch.ones_like(norm))
        scaled = [m["predictor"].duration_proj, m["predictor"].lstm, m["diffusion"]]
        for k in SLM_KEYS:
            for p in m[k].parameters():
                if p.grad is not None:
                    p.grad.mul_(scale_all)
        for mod in scaled:
            for p in mod.parameters():
                if p.grad is not None:
                    p.grad.mul_(sa.scale)

    def slm_discriminator_loss(self, t, y_pred, aux, valid, use_rec: bool,
                               generator: Optional[torch.Generator] = None):
        """The WavLM discriminator's LSGAN loss: real clips of the first slm
        batch items (their no-gradient reconstructions `y_rec_gt_pred` when
        `use_rec`) against the detached `y_pred`, over the valid items; with
        `use_rec`, plus the L1 between its scores of the ground-truth clips
        and of their reconstructions."""
        m = self.models
        r = self._slm_rows(t, aux)
        slm_clip, _ = self.slm_frames()
        need = slm_clip * 2 * HOP
        max_start = torch.clamp(r["mel_lengths"] // 2 - slm_clip, min=1)
        starts = (torch.rand((len(max_start),), generator=generator, device=y_pred.device)
                  * max_start).long().tolist()
        if use_rec:
            real = r["y_rec_gt_pred"][:, :need]
            real = torch.nn.functional.pad(real, (0, need - real.shape[1]))
        else:
            real = clip_slice(r["waves"], [2 * HOP * s for s in starts], need)

        def wd_of(x):
            with torch.no_grad():
                states = L.stack_wavlm_states(run(m, "wavlm", self.mp,
                                                  resample_24k_to_16k(x.detach())))
            return m["wd"](states)

        d_r, d_g = wd_of(real), wd_of(y_pred)
        w = valid.float()[:, None]
        denom = torch.clamp(ddp.global_sum(w.sum()) * d_r.shape[1], min=1.0)
        loss = ddp.global_sum((((1.0 - d_r) ** 2) * w).sum() + ((d_g ** 2) * w).sum()) / denom
        if use_rec:  # the reconstruction-invariance regulariser
            loss = loss + (wd_of(aux["y_rec_gt"]) - wd_of(aux["y_rec_gt_pred"])).abs().mean()
        return loss

    # ------------------------------------------------------------------
    @casts_once
    def train_step(self, batch: Batch, epoch: int, iters: int,
                   rng: np.random.Generator) -> Optional[Dict[str, float]]:
        batch, mel_lengths, own = global_rows(batch)
        cfg, m, opts = self.cfg, self.models, self.state.opts
        lp, sa = cfg.loss_params, cfg.slmadv_params
        diff_on, joint_on = epoch >= lp.diff_epoch, epoch >= lp.joint_epoch
        clip_len = clip_length(cfg, mel_lengths)
        if clip_len is None:
            return None  # too short a batch: the reference skips it
        half = mel_lengths // 2
        starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)[own]
        st_starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)[own]
        num_steps = 3 + int(rng.integers(0, 2))
        use_ind = rng.random() < 0.5
        style_of_batch = bool(use_ind and rng.random() < 0.5)
        use_rec = bool(rng.integers(0, 2))
        seed = ddp.rank_seed(int(rng.integers(0, 2 ** 31)))  # this rank's own stream
        gen = torch.Generator(self.device).manual_seed(seed)
        sigma_data = self.state.sigma_data
        g_keys = self.gen_keys(diff_on, joint_on)
        self._modes(True, g_keys)
        with record_function("forward"):
            t = self._tensors(batch, use_ind)
            g_loss, y_rec, metrics, aux = self.generator_forward(
                t, starts, st_starts, clip_len, diff_on, joint_on, num_steps, sigma_data, gen)
        if diff_on or self.finetune:
            wav_tgt = aux["wav_tgt"]
            # the discriminators first, on the detached reconstruction
            with record_function("discriminators"):
                for k in D_KEYS:
                    m[k].requires_grad_(True)
                y_d = y_rec.detach()
                d_loss = L.discriminator_adv_loss(run(m, "mpd", self.mp, wav_tgt, y_d),
                                                  run(m, "msd", self.mp, wav_tgt, y_d))
                d_loss.backward()
                ddp.all_reduce_grads(m[k] for k in D_KEYS)
                step_modules(m, opts, D_KEYS)
                for k in D_KEYS:
                    m[k].requires_grad_(False)
            # then the adversarial term against the updated discriminators
            with record_function("adversarial"):
                loss_gen = L.generator_adv_loss(run(m, "mpd", self.mp, wav_tgt, y_rec),
                                                run(m, "msd", self.mp, wav_tgt, y_rec))
            g_loss = g_loss + lp.lambda_gen * loss_gen
            metrics.update(d_loss=d_loss, gen=loss_gen, g_loss=g_loss)
        with record_function("backward"):
            g_loss.backward()
        with record_function("optimizer"):
            ddp.all_reduce_grads(m[k] for k in g_keys)
            step_modules(m, opts, g_keys)
            for k in STYLE_KEYS:
                commit_spectral_updates(m[k])
        del g_loss, y_rec
        new_sigma = ddp.mean(aux["s_trg"].std(dim=-1, unbiased=False).mean())
        if joint_on:
            with record_function("slm"):
                self._trainable(SLM_KEYS)
                slm_loss, y_pred, valid = self.slm_generator_loss(t, aux, num_steps, style_of_batch,
                                                                  sigma_data, gen)
                slm_loss.backward()
                ddp.all_reduce_grads(m[k] for k in SLM_KEYS)
                self.scale_slm_grads()
                step_modules(m, opts, SLM_KEYS)
            metrics.update(slm_gen=slm_loss.detach(), slm_valid_frac=valid.float().mean(),
                           slm_sampled=float(not style_of_batch))
            wd_loss = torch.zeros(())
            if (iters + 1) % sa.iter == 0:
                with record_function("slm_d"):
                    self._trainable(("wd",))
                    wd_loss = self.slm_discriminator_loss(t, y_pred.detach(), aux, valid, use_rec, gen)
                    wd_loss.backward()
                    ddp.all_reduce_grads([m["wd"]])
                    step_modules(m, opts, ("wd",))
            metrics["slm_d"] = wd_loss
        self._trainable(())
        self.state.step += 1
        if diff_on and cfg.model_params.diffusion.dist.estimate_sigma_data:
            self.state.sigma_data = float(new_sigma)
        return {k: float(v.detach() if torch.is_tensor(v) else v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def _eval_recon(self, batch: Batch, starts, clip_len: int, generator: torch.Generator):
        """The eval-mode reconstruction of validation and the artifacts: the
        monotonic path, predicted F0 / energy, the styles of the same clip.
        Returns the reconstruction, its target clip and what validation
        scores."""
        m = self.models
        self._modes(False)
        t = self._tensors(batch)
        tokens, lengths, mel_lengths = t["tokens"], t["input_lengths"], t["mel_lengths"]
        mels = preprocess_mel(t["waves"])
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        _, _, _, mono = aligner_pass(m["text_aligner"], mels, mel_lengths, tokens, lengths,
                                     generator)
        asr = m["text_encoder"](tokens, lengths) @ mono
        s_dur_full = m["predictor_encoder"](mels, lengths=mel_lengths)
        _, d_en = self._bert(tokens, lengths)
        dur_logits, p_seq = m["predictor"](d_en, s_dur_full, lengths, mono)
        gt = clip_slice(mels, [2 * s for s in starts], 2 * clip_len)
        wav_clip = clip_slice(t["waves"], [2 * HOP * s for s in starts], clip_len * 2 * HOP)
        f0_fake, n_fake = m["predictor"].F0Ntrain(clip_slice(p_seq, starts, clip_len),
                                                  m["predictor_encoder"](gt))
        y_rec = m["decoder"](clip_slice(asr, starts, clip_len), f0_fake, n_fake,
                             m["style_encoder"](gt), generator)
        return {"y_rec": y_rec, "wav_clip": wav_clip, "dur_logits": dur_logits,
                "d_gt": mono.sum(dim=-1), "lengths": lengths, "f0_fake": f0_fake,
                "f0_real": m["pitch_extractor"](gt)[0]}

    @torch.no_grad()
    def validate(self, batch: Batch, rng: np.random.Generator) -> Optional[Dict[str, float]]:
        """The validation mel, duration and F0 losses of `_eval_recon`."""
        clip_len = clip_length(self.cfg, batch.mel_lengths)
        if clip_len is None:
            return None
        half = batch.mel_lengths // 2
        starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)
        gen = torch.Generator(self.device).manual_seed(int(rng.integers(0, 2 ** 31)))
        r = self._eval_recon(batch, starts, clip_len, gen)
        return {"mel": float(L.multires_stft_loss(r["y_rec"], r["wav_clip"])),
                "dur": float(L.duration_l1_loss(torch.sigmoid(r["dur_logits"]).sum(dim=-1),
                                                r["d_gt"], r["lengths"])),
                "F0": float(L.smooth_l1(r["f0_real"], r["f0_fake"]) / 10.0)}

    @torch.no_grad()
    def eval_artifacts(self, batch: Batch, rng: np.random.Generator,
                       sample: bool = False) -> Optional[dict]:
        """An epoch's eval audio, {"audio": {tag: wave}}, after the JAX
        trainer's. Without `sample` (before joint_epoch): the validation
        reconstructions of the first 3 samples ("y_rec_b") and their target
        clips ("gt_b"); None for a batch too short to clip. With it: the
        full synthesis path on the first sample, "sampled_0" beside its
        utterance "gt_0": 5 ADPM2 steps at the state's sigma_data from
        PL-BERT (and, multispeaker, the utterance's own styles), rounded
        durations, a decode padded to a 100-frame bucket and trimmed to the
        predicted frames. The draws come from a seed drawn from `rng`."""
        gen = torch.Generator(self.device).manual_seed(int(rng.integers(0, 2 ** 31)))
        if not sample:
            clip_len = clip_length(self.cfg, batch.mel_lengths)
            if clip_len is None:
                return None
            half = batch.mel_lengths // 2
            starts = rng.integers(0, np.maximum(half - clip_len, 1)).astype(np.int64)
            r = self._eval_recon(batch, starts, clip_len, gen)
            audio = {}
            for b in range(min(3, len(r["y_rec"]))):
                audio[f"y_rec_{b}"] = r["y_rec"][b].float().cpu().numpy()
                audio[f"gt_{b}"] = r["wav_clip"][b].cpu().numpy()
            return {"audio": audio}
        wav, total = self._sample_utterance(batch, gen)
        return {"audio": {"sampled_0": wav[: total * SAMPLES_PER_FRAME],
                          "gt_0": np.asarray(batch.waves[0][: int(batch.wave_lengths[0])])}}

    def _sample_utterance(self, batch: Batch, generator: torch.Generator):
        """The first sample's text synthesised with a sampled style: (the
        decoded wave of the bucketed frames, the predicted frame total).
        The stages of `Synthesizer._run` as the JAX trainer runs them:
        without HiFi-GAN's one-frame shift and the alpha/beta style mix."""
        m, sd = self.models, self.cfg.model_params.style_dim
        self._modes(False)
        t = self._tensors(batch)
        tokens, lengths = t["tokens"][:1], t["input_lengths"][:1]
        bert_dur, d_en = self._bert(tokens, lengths)
        feats = None
        if self.multispeaker:
            mels = preprocess_mel(t["waves"][:1])
            feats = torch.cat([m[k](mels, lengths=t["mel_lengths"][:1])
                               for k in ("style_encoder", "predictor_encoder")], dim=-1)

        def net(x, c_noise):
            return m["diffusion"](x, c_noise, bert_dur, features=feats, embedding_lengths=lengths)

        noise = torch.randn((1, 1, 2 * sd), generator=generator, device=tokens.device)
        s_pred = sample_adpm2(make_denoise_fn(net, self.state.sigma_data), noise, 5,
                              generator)[:, 0]
        ref, s = s_pred[:, :sd], s_pred[:, sd:]
        d = m["predictor"].encode_texts(d_en, s, lengths)
        dur = torch.sigmoid(m["predictor"].duration(d, lengths)).sum(dim=-1)
        valid = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
        pred_dur = torch.where(valid, torch.clamp(torch.round(dur), min=1.0), 0.0).to(torch.int64)
        total = int(pred_dur.sum())
        aln = duration_to_alignment(pred_dur, max(100, -(-total // 100) * 100))
        f0, n = m["predictor"].F0Ntrain(d.transpose(1, 2) @ aln, s)
        asr = m["text_encoder"](tokens, lengths) @ aln
        wav = m["decoder"](asr, f0, n, ref, generator)
        return wav[0].float().cpu().numpy(), total
