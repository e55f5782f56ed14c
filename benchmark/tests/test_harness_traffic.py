"""The traffic generator: a seed fixes a run's requests, seeds share sizes."""

import json

import numpy as np
import pytest

from benchmark import traffic
from benchmark.reference.text import SYMBOL_TO_ID, encode
from benchmark.tests.tiny import HOME

CELLS = ["ljspeech.poisson", "libritts.poisson-voices", "ljspeech.single", "ljspeech.saturated"]
BIG = 2 ** 31 + 987654321  # seeds run past 32 signed bits


def _spec(cell):
    return json.loads((HOME / "workloads" / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_schedule_repeats_per_seed_and_differs_across_seeds(cell):
    spec = _spec(cell)
    a, b, c = (traffic.schedule(spec, s, 5.0) for s in (BIG, BIG, BIG + 1))
    assert [(r.due, r.text, r.voice) for r in a] == [(r.due, r.text, r.voice) for r in b]
    assert [r.text for r in a] != [r.text for r in c]
    # the same set of sizes and gaps in another order
    assert sorted(r.tokens for r in a) == sorted(r.tokens for r in c)
    if "order_seed" in spec:  # one trace for every seed: the same gaps and lengths in one order
        assert [(r.due, r.tokens) for r in a] == [(r.due, r.tokens) for r in c]
    elif spec["load"]["kind"] == "open":
        assert [r.due for r in a] != [r.due for r in c]
        # n - 1 gaps of the same n (the one after the last arrival is not seen)
        ga, gc = np.diff([r.due for r in a]), np.diff([r.due for r in c])
        assert sum(np.isclose(gc, g, rtol=1e-9).any() for g in ga) >= len(ga) - 1
    if spec["load"]["kind"] == "open":
        assert a[-1].due < 5.0 and len(a) == round(spec["load"]["rate_per_s"] * 5.0)


@pytest.mark.parametrize("cell", CELLS)
def test_texts_have_their_token_counts(cell):
    spec = _spec(cell)
    sched = traffic.schedule(spec, 3, 4.0)
    for r in sched:
        assert all(ch in SYMBOL_TO_ID for ch in r.text)
        assert len(encode(r.text)) == r.tokens
    assert len({r.text for r in sched}) == len(sched)
    tok = spec["tokens"]
    lo = tok["min"] + 1
    assert min(r.tokens for r in sched) >= lo
    if tok["dist"] == "normal":
        assert max(r.tokens for r in sched) <= tok["max"] + 1
        assert abs(np.mean([r.tokens for r in traffic.schedule(spec, 3, 60.0)]) - tok["mean"] - 1) < 3


def test_voices_follow_zipf_and_waves_repeat():
    spec = _spec("libritts.poisson-voices")
    sched = traffic.schedule(spec, 5, 20.0)
    counts = [sum(r.voice == v for r in sched) for v in traffic.voice_names(spec)]
    assert counts == sorted(counts, reverse=True) and counts[0] > 3 * counts[7]
    w1, w2, w3 = (traffic.voice_waves(spec, s) for s in (5, 5, 6))
    assert all(np.array_equal(w1[k], w2[k]) for k in w1)
    assert not np.array_equal(w1["v00"], w3["v00"])
    assert len(w1["v00"]) == 3 * 24000 and np.abs(w1["v00"]).max() <= 0.41
