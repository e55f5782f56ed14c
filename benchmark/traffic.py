"""The one traffic generator: a workload file's parameters and a seed -> the
requests of a run.

Every seed gets the same set of sizes and gaps: token counts are the
length distribution's quantiles at (i + 0.5) / n, and an open loop's gaps
the exponential's, scaled so that the n-th arrival falls just inside the
window, in an order drawn from the seed, or from the file's `order_seed`
(then one trace for every run: where the order moves the tail more than
runs of one seed differ); the texts and the voices' waves change with the
seed. Texts are phonemized
English-like IPA (syllables of the inventory below, stress marks, spaces,
commas, a final period) of exactly the drawn number of tokens.

Workload keys:
  entry        "http" (POST /tts to a TTSServer) or "library" (Synthesizer.inference)
  load         {"kind": "open", "rate_per_s": r} | {"kind": "closed", "clients": c}
  requests_per_s  closed loops: the texts drawn per second of window (a pool
               the clients take in order)
  tokens       {"dist": "normal", "mean", "sd", "min", "max"} or
               {"dist": "lognormal_seconds", "median_s", "sigma", "max_s",
                "s_per_token", "min"}: tokens with the pad in front excluded
  voices       {"count", "zipf_s", "seconds"}: reference waves made from the
               seed, each request picks one by Zipf(zipf_s) (multispeaker)
  server       {"max_batch", "window_ms"}: the TTSServer's settings
  check        {"batches": n}: synthesis calls the reference recomputes
  order_seed   optional: the arrival gaps and the lengths in one order for
               every run (a fixed trace; the seed still draws the texts,
               the voices' waves and picks, and the weights); without it
               the run's seed orders them
"""

from __future__ import annotations

import math
import random
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

CONSONANTS = ["p", "b", "t", "d", "k", "ɡ", "f", "v", "θ", "ð", "s", "z", "ʃ", "ʒ", "h", "m", "n",
              "ŋ", "l", "ɹ", "w", "j", "tʃ", "dʒ"]
VOWELS = ["ɪ", "ɛ", "æ", "ʌ", "ʊ", "ɑː", "ɔː", "ə", "iː", "uː", "eɪ", "aɪ", "oʊ", "aʊ", "ɔɪ", "ɜː",
          "ɚ", "ᵻ"]


@dataclass
class Request:
    id: int
    due: Optional[float]  # seconds after the window opens (open loop), else None
    text: str
    tokens: int  # with the pad in front
    voice: Optional[str]


def _quantiles(dist: dict, n: int) -> List[int]:
    """n token counts at the distribution's quantiles (i + 0.5) / n."""
    ps = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "normal":
        nd = statistics.NormalDist(dist["mean"], dist["sd"])
        lo, hi = nd.cdf(dist["min"] - 0.5), nd.cdf(dist["max"] + 0.5)
        out = [nd.inv_cdf(lo + p * (hi - lo)) for p in ps]
        return [min(dist["max"], max(dist["min"], round(x))) for x in out]
    if dist["dist"] == "lognormal_seconds":
        nd = statistics.NormalDist(math.log(dist["median_s"]), dist["sigma"])
        hi = nd.cdf(math.log(dist["max_s"]))
        secs = [math.exp(nd.inv_cdf(p * hi)) for p in ps]
        return [max(dist["min"], round(s / dist["s_per_token"])) for s in secs]
    raise ValueError(f"unknown token distribution {dist['dist']!r}")


def text_of(n_chars: int, rng: random.Random) -> str:
    """A phonemized text of exactly n_chars characters of the symbol table
    (so n_chars + 1 tokens), ending in a period."""
    out: List[str] = []
    size = 0
    word = 0
    while size < n_chars - 1:
        if word and rng.random() < 0.35:  # end the word
            out.append(", " if rng.random() < 0.08 else " ")
            word = 0
        else:
            syl = ("ˈ" if word == 0 and rng.random() < 0.5 else "") + \
                (rng.choice(CONSONANTS) if rng.random() < 0.8 else "") + rng.choice(VOWELS) + \
                (rng.choice(CONSONANTS) if rng.random() < 0.4 else "")
            out.append(syl)
            word += 1
        size = len("".join(out))
    text = "".join(out)[: n_chars - 1].rstrip(" ,")
    while len(text) < n_chars - 1:
        text += rng.choice("aeiou")
    return text + "."


def texts(n: int, dist: dict, rng: random.Random,
          order: Optional[random.Random] = None) -> List[str]:
    """n distinct texts whose token counts are the distribution's quantiles,
    shuffled by `order` (default `rng`), their characters drawn from `rng`."""
    counts = _quantiles(dist, n)
    (order or rng).shuffle(counts)
    seen, out = set(), []
    for c in counts:
        t = text_of(c, rng)
        while t in seen:
            t = text_of(c, rng)
        seen.add(t)
        out.append(t)
    return out


def voice_names(spec: dict) -> List[str]:
    v = spec.get("voices")
    return [f"v{i:02d}" for i in range(v["count"])] if v else []


def voice_waves(spec: dict, seed: int, sr: int = 24000) -> Dict[str, np.ndarray]:
    """Seeded speech-like reference waves: a harmonic source on a gliding
    pitch (80-260 Hz) with a syllable-rate envelope, plus noise."""
    v = spec["voices"]
    rng = np.random.default_rng([seed, 7])
    n = int(v["seconds"] * sr)
    t = np.arange(n) / sr
    out = {}
    for name in voice_names(spec):
        f0 = rng.uniform(80, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        amps = rng.uniform(0.1, 1.0, 12) / np.arange(1, 13)
        w = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 6.28)) ** 2
        w = w * env + 0.02 * rng.standard_normal(n)
        out[name] = (0.4 * w / np.abs(w).max()).astype(np.float32)
    return out


def schedule(spec: dict, seed: int, seconds: float) -> List[Request]:
    """The run's requests in the order they are sent."""
    rng = random.Random(seed)
    order = random.Random(spec["order_seed"]) if "order_seed" in spec else rng
    load = spec["load"]
    if load["kind"] == "open":
        n = max(1, round(load["rate_per_s"] * seconds))
        gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
        order.shuffle(gaps)
        scale = seconds * (1.0 - 0.5 / n) / sum(gaps)
        dues, acc = [], 0.0
        for g in gaps:
            dues.append(acc)
            acc += g * scale
    else:
        n = max(1, round(spec["requests_per_s"] * seconds))
        dues = [None] * n
    voices = voice_names(spec)
    picks: List[Optional[str]] = [None] * n
    if voices:
        w = np.array([1.0 / (k + 1) ** spec["voices"]["zipf_s"] for k in range(len(voices))])
        counts = np.floor(w / w.sum() * n).astype(int)
        counts[: n - counts.sum()] += 1
        picks = [v for v, c in zip(voices, counts) for _ in range(c)]
        rng.shuffle(picks)
    tx = texts(n, spec["tokens"], rng, order)
    return [Request(i, d, t, len(t) + 1, v) for i, (d, t, v) in enumerate(zip(dues, tx, picks))]
