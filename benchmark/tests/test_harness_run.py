"""Whole runs of cells defined only in test-local files (a tiny-width
configuration, three traffic mixes), on the CPU: the harness finds them by
name and reads their answers as correct; with the timed path broken
underneath, each fault a serving cell can have makes `correct` false."""

import json

import numpy as np
import pytest
import torch

from benchmark import run, spec
from benchmark.tests.tiny import make_tree

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_tree(tmp_path_factory.mktemp("tree"))


def _run(root, name, seconds=2.5, seed=SEED):
    cell = spec.load(name, root)
    return run.run_cell(cell, seed, seconds, False, device="cpu", t_start=0.0)


@pytest.mark.parametrize("name", ["tiny.poisson", "tiny.single", "tiny-ms.voices"])
def test_a_cell_of_its_own_files_runs_and_is_correct(root, name):
    res = _run(root, name)
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = [m["name"] for m in spec.load(name, root).end_to_end]
    assert sorted(res["metrics"]) == sorted(names)
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checked"
    json.dumps(res)


def _altered_answer(monkeypatch):
    from styletts2_tpu_torch.inference import Synthesizer

    decode = Synthesizer._decode

    def altered(self, *a, **k):
        (wav,) = decode(self, *a, **k)
        return (wav * 1.01,)

    monkeypatch.setattr(Synthesizer, "_decode", altered)


def _half_batch(monkeypatch):
    """Synthesizes the first half of each batch and answers the rest with it.
    Each call first holds the worker a while, so that the other clients'
    requests queue and batches of more than one form (a lone request has no
    half to leave out)."""
    import time

    from styletts2_tpu_torch.inference import Synthesizer

    batch = Synthesizer.inference_batch

    def half(self, texts, ref_s=None, **kw):
        time.sleep(0.2)
        n = (len(texts) + 1) // 2
        ref = None if ref_s is None else np.asarray(ref_s)[:n]
        wavs = batch(self, texts[:n], ref_s=ref, **kw)
        return [wavs[i % n] for i in range(len(texts))]

    monkeypatch.setattr(Synthesizer, "inference_batch", half)


def _altered_token(monkeypatch):
    import styletts2_tpu_torch.inference as inf

    enc = inf.encode_text

    def altered(text):
        ids = enc(text)
        ids[len(ids) // 2] = (ids[len(ids) // 2] + 1) % 178
        return ids

    monkeypatch.setattr(inf, "encode_text", altered)


@pytest.mark.parametrize("fault", [_altered_answer, _half_batch, _altered_token],
                         ids=["answer_altered", "half_batch_left_out", "token_altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(root, "tiny-ms.voices")
    assert not res["correct"], res["checked"]


def test_the_sweep_runs_windows_at_each_rate_after_one_set_up(root):
    """`sweep.py`'s windows: each rate's windows after one set-up, every
    request answered, no key captured inside a window, and a summary of
    spreads a rate."""
    cell = spec.load("tiny.poisson", root)
    ws = list(spec.entry_module(cell.home, cell.harness).sweep(cell, SEED, 1.5, [1.0, 3.0], 2,
                                                              device="cpu"))
    assert [(w["rate_per_s"], w["window"]) for w in ws] == [(1.0, 0), (1.0, 1), (3.0, 0),
                                                            (3.0, 1)]
    assert all(w["failed"] == 0 and w["captured"] == 0 and w["batch_mean"] >= 1 for w in ws)
    assert [w["attempted"] for w in ws] == [2, 2, 4, 4]
