"""The synthesis API's semantics on the plain reference, for one batch.

What `Synthesizer.inference_batch` and `Synthesizer.inference` document:
tokens padded to a text bucket of 64; the starting noise drawn from
`seed + 1`, the churn and the source from one generator seeded `seed`;
durations max(round(d), 1), then on the host max(round(d / speed), 1) and
+5 frames on the last token when single-speaker; one frame bucket of 100
for the batch; the decoder over the bucket (HiFi-GAN's input shifted one
frame right); each waveform cut to sum(durations) * 600 samples, less 50
when multispeaker; a served WAV is 16-bit, trunc(clip(w) * 32767).

A rounded duration is a step function of a float that two correct
implementations compute a few ulps apart. So a token whose unrounded
duration lies within `TIE` of a half is rounded both ways; the candidates
are the durations these choices give, and the one whose length matches
the answer is judged.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.model import Reference, _bucket
from benchmark.reference.text import encode

SAMPLES_PER_FRAME = 600
TEXT_BUCKET, FRAME_BUCKET = 64, 100
TIE = 2e-3  # frames: how near a half an unrounded duration is rounded both ways
MAX_TIES = 6  # per row; beyond it only the first MAX_TIES are tried


class Row(NamedTuple):
    candidates: List[np.ndarray]  # the waveforms whose length matches (float32 or int16)
    frames: List[int]  # every candidate's length in frames, matching or not


def pcm16(w: np.ndarray) -> np.ndarray:
    return (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)


def _host_round(dur: np.ndarray, speed: float, pad_last: bool) -> np.ndarray:
    out = dur.astype(np.int64)
    if speed != 1.0:
        out = np.maximum(np.round(out / speed), 1).astype(np.int64)
    if pad_last:
        out[-1] += 5
    return out


def _candidates(dur: np.ndarray, speed: float, pad_last: bool) -> List[np.ndarray]:
    """Each row's durations after every rounding the near-ties allow, the
    nearest rounding first."""
    base = np.maximum(np.round(dur), 1.0)
    frac = dur - np.floor(dur)
    ties = np.nonzero((np.abs(frac - 0.5) < TIE) & (dur > 1.0))[0][:MAX_TIES]
    out, seen = [], set()
    for flips in itertools.product((False, True), repeat=len(ties)):
        d = base.copy()
        for t, f in zip(ties, flips):
            if f:
                d[t] = np.floor(dur[t]) if d[t] > dur[t] else np.ceil(dur[t])
        final = _host_round(d, speed, pad_last)
        key = final.tobytes()
        if key not in seen:
            seen.add(key)
            out.append(final)
    return out


@torch.inference_mode()
def synthesize(ref: Reference, texts: Sequence[str], feats: Optional[np.ndarray], *, alpha: float,
               beta: float, steps: int, scale: float, speed: float, seed: int, sigma_data: float,
               served_frames: Optional[Sequence[int]] = None, wav16: bool = True) -> List[Row]:
    """The batch `texts` (feats: (B, 2 * style_dim) reference styles, or
    None) as the API synthesizes it. With `served_frames` (each answer's
    length in frames) each row keeps the candidates of that length, and the
    frame bucket is that of the longest answer; without, the nearest
    rounding alone."""
    dev, B = ref.device, len(texts)
    toks = [encode(t) for t in texts]
    lengths = torch.tensor([len(t) for t in toks])
    tokens = torch.zeros((B, _bucket(int(lengths.max()), TEXT_BUCKET)), dtype=torch.int64)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = torch.from_numpy(t)
    D = 2 * ref.sdim
    f = torch.zeros((B, D)) if feats is None else torch.as_tensor(
        np.asarray(feats, np.float32)).reshape(-1, D).expand(B, D)
    noise = torch.randn((B, 1, D), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed + 1))
    gen = torch.Generator(dev).manual_seed(seed)
    t_en, d, s, rstyle, dur = ref.phase_a(tokens.to(dev), lengths.to(dev), noise, f.to(dev),
                                          alpha, beta, steps, scale, gen, sigma_data)
    after_a = gen.get_state()
    dur = dur.double().cpu().numpy()
    pad_last = not ref.multispeaker
    trim = 50 if ref.multispeaker else 0
    cands = [_candidates(dur[i, : len(t)], speed, pad_last) for i, t in enumerate(toks)]
    frames = [[int(c.sum()) for c in cs] for cs in cands]
    if served_frames is None:
        keep = [[cs[0]] for cs in cands]
        n_frames = _bucket(max(fr[0] for fr in frames), FRAME_BUCKET)
    else:
        keep = [[c for c in cs if int(c.sum()) == sf] for cs, sf in zip(cands, served_frames)]
        n_frames = _bucket(int(max(served_frames)), FRAME_BUCKET)
    passes = max(1, max(len(k) for k in keep))
    rows = [Row([], fr) for fr in frames]
    T = tokens.shape[1]
    for p in range(passes):
        pd = np.zeros((B, T), np.int64)
        for i, (k, cs) in enumerate(zip(keep, cands)):
            pd[i, : len(toks[i])] = (k[min(p, len(k) - 1)] if k else cs[0])
        gen.set_state(after_a)
        asr, F0, N = ref.prosody(t_en, d, s, torch.from_numpy(pd).to(dev), n_frames)
        wav = ref.decode(asr, F0, N, rstyle, gen).cpu().numpy()
        for i, k in enumerate(keep):
            if p < len(k):
                w = wav[i, : int(k[p].sum()) * SAMPLES_PER_FRAME - trim]
                rows[i].candidates.append(pcm16(w) if wav16 else w.astype(np.float32))
    return rows


def speed_for(ref: Reference, texts: Sequence[str], frames_per_token: float, seed: int,
              sigma_data: float, feats: Optional[np.ndarray] = None) -> float:
    """The one speed at which the batch `texts`' mean duration per token is
    `frames_per_token`: random weights give durations ~8x too long."""
    dev, B = ref.device, len(texts)
    toks = [encode(t) for t in texts]
    lengths = torch.tensor([len(t) for t in toks])
    tokens = torch.zeros((B, _bucket(int(lengths.max()), TEXT_BUCKET)), dtype=torch.int64)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = torch.from_numpy(t)
    D = 2 * ref.sdim
    f = torch.zeros((B, D)) if feats is None else torch.as_tensor(np.asarray(feats, np.float32))
    noise = torch.randn((B, 1, D), device=dev, generator=torch.Generator(dev).manual_seed(seed))
    with torch.inference_mode():
        *_, dur = ref.phase_a(tokens.to(dev), lengths.to(dev), noise, f.to(dev), 0.3, 0.7, 5, 1.0,
                              torch.Generator(dev).manual_seed(seed), sigma_data)
    rounded = torch.clamp(torch.round(dur), min=1.0).cpu()
    valid = torch.arange(tokens.shape[1])[None, :] < lengths[:, None]
    per_token = float(rounded[valid].sum()) / float(lengths.sum())
    return max(per_token / frames_per_token, 1.0)
