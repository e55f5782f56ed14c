"""What decides `correct`: answers recomputed by the plain reference.

After the window the run draws, from its seed, synthesis calls that
finished inside it, the call with the longest answer always among them.
The reference synthesizes each drawn call's batch again (its texts, in
its order, with its reference styles and settings) and every answer of
the batch is judged:

  frames_mismatch  answers whose length no rounding of the reference's
                   durations gives (limit 0)
  wav_gap          the widest gap between an answer's samples and the
                   reference's, as a share of the reference's peak, the
                   worst over the judged answers
  failed           requests due in the window that failed or never
                   finished (limit 0)
"""

from __future__ import annotations

import random
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.reference import synth
from benchmark.reference.model import Reference

# set from the readings in PERF.md ("How correct is decided"): the largest
# sound run's wav_gap over a dozen seeds and more, and the smallest of the
# reference's own with TF32 on (the control)
LIMITS = {"frames_mismatch": 0, "failed": 0, "wav_gap": 5e-4}


def draw(calls: Sequence[dict], n: int, seed: int) -> List[dict]:
    """n of the finished calls, drawn from `seed`, the one with the
    longest answer first."""
    if not calls:
        return []
    longest = max(calls, key=lambda c: max(c["frames"]))
    rest = [c for c in calls if c is not longest]
    random.Random(seed ^ 0x5EED).shuffle(rest)
    return [longest] + rest[: n - 1]


def gap(answer: np.ndarray, candidates: List[np.ndarray]) -> Optional[float]:
    """The least, over the candidates of the answer's length, of the widest
    sample gap as a share of the candidate's peak; None without one."""
    out = None
    for c in candidates:
        if len(c) != len(answer):
            continue
        a, b = answer.astype(np.float64), c.astype(np.float64)
        g = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)) if len(b) else 0.0
        out = g if out is None else min(out, g)
    return out


def judge(ref: Reference, calls: Sequence[dict], answers: Dict[int, np.ndarray], *, trim: int,
          wav16: bool, sampler: dict) -> Dict[str, float]:
    """`calls`: each {"texts", "feats" ((B, D) or None), "ids", "speed",
    "seed"}; `answers`: each id's answer (int16 samples, or float32).
    Returns frames_mismatch and wav_gap over the calls' answers, and logs
    where the widest gap lies."""
    mismatch, worst, where = 0, 0.0, ""
    for n, call in enumerate(calls):
        served = [answers[i] for i in call["ids"]]
        rows = synth.synthesize(
            ref, call["texts"], call["feats"], alpha=sampler["alpha"], beta=sampler["beta"],
            steps=sampler["diffusion_steps"], scale=sampler["embedding_scale"],
            speed=call["speed"], seed=call["seed"], sigma_data=sampler["sigma_data"],
            served_frames=[(len(a) + trim) // synth.SAMPLES_PER_FRAME for a in served],
            wav16=wav16)
        for i, (a, row) in enumerate(zip(served, rows)):
            g = gap(a, row.candidates)
            if g is None:
                mismatch += 1
            elif g >= worst:
                d = min((np.abs(a.astype(np.float64) - c) for c in row.candidates
                         if len(c) == len(a)), key=np.max)
                worst, where = g, (f"call {n} of {len(calls)} (B {len(served)}), row {i}, sample "
                                   f"{int(d.argmax())} of {len(a)}")
    if where:
        print(f"widest wav_gap {worst!r}: {where}", file=sys.stderr, flush=True)
    return {"frames_mismatch": mismatch, "wav_gap": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float] = LIMITS) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
