"""Training losses (`styletts2_tpu/losses.py:50-211`,
`styletts2_tpu/train/stage1.py:75-84`).

The multi-resolution loss is the mean over three resolutions of the mel
spectral convergence |y - x|_1 / |y|_1 on log-normalised mels with a 24 kHz
filterbank. The adversarial losses aggregate LSGAN, feature matching (x2)
and the truncated pointwise relativistic loss (TPRLS, tau 0.04, with
torch.median's lower median) over the (real, generated, real feature maps,
generated feature maps) tuples of the MPD and the MRSD. Every loss
accumulates in f32. Stage 2 adds the duration losses (binary CE on the
duration bins, L1 on the summed durations over interior tokens), smooth L1
for F0 and energy, and the stacking of WavLM states for its discriminator.

In a data-parallel step (`parallel/ddp.py`) the two terms that are not
means of per-row terms are taken over the global batch: the
multi-resolution loss's sums through `ddp.global_sum`, TPRLS's median over
the ranks' rows gathered by `ddp.gather_rows`. Every other loss is a mean
of per-row terms over equal shards.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from styletts2_tpu_torch.ops.stft import MEL_MEAN, MEL_STD, melspectrogram
from styletts2_tpu_torch.parallel import ddp

MRSTFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _log_norm_mel(wav, n_fft, hop, win):
    mel = melspectrogram(wav, n_fft=n_fft, win_length=win, hop_length=hop, fb_sample_rate=24000)
    return (torch.log(1e-5 + mel) - MEL_MEAN) / MEL_STD


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: predicted wave (B, T); y: target wave (B, T)."""
    x, y = x.float(), y.float()
    total = 0.0
    for n_fft, hop, win in MRSTFT_RESOLUTIONS:
        xm = _log_norm_mel(x, n_fft, hop, win)
        ym = _log_norm_mel(y, n_fft, hop, win)
        total = total + ddp.global_sum((ym - xm).abs().sum()) / ddp.global_sum(ym.abs().sum())
    return total / len(MRSTFT_RESOLUTIONS)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2.0


def lsgan_d_loss(real_outputs, gen_outputs) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_outputs, gen_outputs):
        loss = loss + ((1.0 - dr.float()) ** 2).mean() + (dg.float() ** 2).mean()
    return loss


def lsgan_g_loss(gen_outputs) -> torch.Tensor:
    loss = 0.0
    for dg in gen_outputs:
        loss = loss + ((1.0 - dg.float()) ** 2).mean()
    return loss


def tprls_loss(first_outputs, second_outputs, tau: float = 0.04) -> torch.Tensor:
    """Truncated pointwise relativistic LS loss over diff = first - second:
    with m the lower median of diff, tau - relu(tau - mean((diff - m)^2 over
    diff < m)). Not symmetric: the discriminator passes (real, generated),
    the generator (generated, real)."""
    loss = 0.0
    for da, db in zip(first_outputs, second_outputs):
        diff = ddp.gather_rows(da.float()) - ddp.gather_rows(db.float())
        m = torch.median(diff)  # the lower of the two middle values, as the JAX package
        mask = (diff < m).float()
        l_rel = (((diff - m) ** 2) * mask).sum() / mask.sum().clamp(min=1.0)
        loss = loss + tau - F.relu(tau - l_rel)
    return loss


def generator_adv_loss(mpd_out, msd_out) -> torch.Tensor:
    y_df_r, y_df_g, fmap_f_r, fmap_f_g = mpd_out
    y_ds_r, y_ds_g, fmap_s_r, fmap_s_g = msd_out
    return (lsgan_g_loss(y_df_g) + lsgan_g_loss(y_ds_g)
            + feature_loss(fmap_f_r, fmap_f_g) + feature_loss(fmap_s_r, fmap_s_g)
            + tprls_loss(y_df_g, y_df_r) + tprls_loss(y_ds_g, y_ds_r))


def discriminator_adv_loss(mpd_out, msd_out) -> torch.Tensor:
    y_df_r, y_df_g, _, _ = mpd_out
    y_ds_r, y_ds_g, _, _ = msd_out
    return (lsgan_d_loss(y_df_r, y_df_g) + lsgan_d_loss(y_ds_r, y_ds_g)
            + tprls_loss(y_df_r, y_df_g) + tprls_loss(y_ds_r, y_ds_g))


def wavlm_feature_loss(wav_states: Sequence, rec_states: Sequence) -> torch.Tensor:
    """L1 feature matching over every WavLM hidden state; the real states
    carry no gradient."""
    loss = 0.0
    for er, eg in zip(wav_states, rec_states):
        loss = loss + (er.detach().float() - eg.float()).abs().mean()
    return loss


def s2s_ce_loss(s2s_pred, tokens, input_lengths) -> torch.Tensor:
    """Cross-entropy of the aligner's decoder logits (B, T+1, V) on the first
    T steps against the tokens (B, T): per sample over its valid tokens,
    then the batch mean."""
    T = tokens.shape[1]
    logp = torch.log_softmax(s2s_pred[:, :T].float(), dim=-1)
    nll = -logp.gather(-1, tokens[..., None].long())[..., 0]  # (B, T)
    valid = (torch.arange(T, device=tokens.device)[None, :] < input_lengths[:, None]).float()
    per = (nll * valid).sum(dim=1) / input_lengths.clamp(min=1).float()
    return per.mean()


def stack_wavlm_states(states: Sequence[torch.Tensor]) -> torch.Tensor:
    """The hidden states (B, T, H) each -> (B, T, len(states) * H) f32, the
    WavLM discriminator's input (its head stays f32 under bf16 training)."""
    return torch.cat([s.float() for s in states], dim=-1)


def duration_ce_loss(dur_logits, durations, lengths) -> torch.Tensor:
    """Binary CE of the duration logits (B, T, max_dur) against the step
    targets target[b, t, k] = k < durations[b, t]: the mean over the bins,
    per sample over its valid tokens, then the batch mean."""
    B, T, D = dur_logits.shape
    x = dur_logits.float()
    steps = torch.arange(D, device=x.device)[None, None, :]
    target = (steps < durations[..., None]).float()
    ce = x.clamp(min=0) - x * target + torch.log1p(torch.exp(-x.abs()))
    valid = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).float()
    per_sample = (ce.mean(dim=-1) * valid).sum(dim=1) / lengths.clamp(min=1).float()
    return per_sample.mean()


def duration_l1_loss(dur_pred_sum, durations, lengths) -> torch.Tensor:
    """L1 of the summed durations (B, T) over the interior tokens 1 ..
    len - 2 (the reference drops the boundary tokens): per sample, then the
    batch mean."""
    T = dur_pred_sum.shape[1]
    idx = torch.arange(T, device=dur_pred_sum.device)[None, :]
    interior = ((idx >= 1) & (idx < lengths[:, None] - 1)).float()
    per_sample = ((dur_pred_sum.float() - durations).abs() * interior).sum(dim=1) / (
        interior.sum(dim=1).clamp(min=1.0))
    return per_sample.mean()


def smooth_l1(x, y, beta: float = 1.0) -> torch.Tensor:
    d = (x.float() - y.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()
