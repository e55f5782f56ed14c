"""The readers of the program's spans (`benchmark/spans.py` and the metrics
that use it): each on a hand-made span log, the cut at the first traced
call, each `.p50` copy reading as its original, a program without the
recorder reading nothing, and a whole CPU run of a tiny serving cell
read."""

import json
from types import SimpleNamespace

import pytest

from benchmark import run, spans, spec
from benchmark.spec import ROOT
from benchmark.tests.tiny import make_tree

HOME = ROOT / json.loads((ROOT / "BENCHMARK.json").read_text())["paths"][0]
READERS = ["serve.queue_wait_ms", "inference.host_ms", "decode.device_ms_per_audio_s",
           "decode.pad_share"]  # each with a `.p50` copy
ALL = READERS + ["serve.queue_median_ms", "serve.http_ms"]
S = 1_000_000_000  # ns a second


def _span(id, name, start_s, end_s, parent=None, **attrs):
    return SimpleNamespace(id=id, parent=parent, request=None, name=name,
                           start_ns=int(start_s * S), end_ns=int(end_s * S), attrs=attrs)


def _log():
    """Two requests queued 10 and 30 ms, one batch of both (decoded 2 x 100
    frames, answered 120, the decode 6 ms on the card, 20 ms of it waited
    for), then a third request whose queue and call start after the first
    traced call, and a span before the window. Over HTTP: an answered
    request with 1 ms to its parse's end and 5 ms from its encode's start, a
    refused one, and after the first traced call one with 100 ms of each."""
    return [
        _span(1, "serve.queue", 0.5, 7.0),  # before the window
        _span(2, "serve.queue", 10.000, 10.010),
        _span(3, "serve.queue", 10.000, 10.030),
        _span(4, "inference.call", 10.030, 10.080, frames_decoded=200, frames_answered=120),
        _span(5, "decode", 10.050, 10.055, parent=4, device_ms=6.0),
        _span(6, "inference.wait", 10.040, 10.045, parent=4),
        _span(7, "inference.wait", 10.060, 10.075, parent=4),
        _span(8, "serve.queue", 20.0, 20.5),
        _span(9, "inference.call", 20.5, 20.6, frames_decoded=100, frames_answered=100),
        _span(10, "decode", 20.55, 20.56, parent=9, device_ms=9.0),
        _span(11, "serve.request", 9.999, 10.090, status=200),
        _span(12, "serve.parse", 9.999, 10.000, parent=11),
        _span(13, "serve.encode", 10.085, 10.088, parent=11),
        _span(14, "serve.request", 10.100, 10.200, status=400),
        _span(15, "serve.parse", 10.100, 10.150, parent=14),
        _span(16, "serve.request", 20.25, 20.7, status=200),
        _span(17, "serve.parse", 20.25, 20.35, parent=16),
        _span(18, "serve.encode", 20.6, 20.7, parent=16),
    ]


def _run(traced_at=None):
    calls = [{"t0": 10.03, "t1": 10.08, "traced": False}]
    if traced_at is not None:
        calls.append({"t0": traced_at, "t1": traced_at + 0.1, "traced": True})
    return SimpleNamespace(window=(8.0, 48.0), calls=calls)


@pytest.fixture
def log(monkeypatch):
    monkeypatch.setattr(spans, "_snapshot", _log)


@pytest.mark.parametrize("name,want", [
    ("serve.queue_wait_ms", 30.0),  # the larger of the two waits: rank 2 of 2
    ("inference.host_ms", 30.0),  # 50 ms less 5 + 15 ms waited
    ("decode.device_ms_per_audio_s", 6.0 / 3.0),  # 120 frames = 3 s of audio
    ("decode.pad_share", 40.0),  # 1 - 120 / 200
    ("serve.queue_median_ms", 20.0),  # the median of 10 and 30 ms
    ("serve.http_ms", 6.0),  # 1 + 5 ms of the answered request; the refused one left out
])
def test_each_reader_on_a_span_log_cut_at_the_first_traced_call(log, name, want):
    read = spec.reader(HOME, name)
    assert read(_run(traced_at=20.2)) == pytest.approx(want)
    assert read(_run()) != pytest.approx(want)  # untraced: the whole window


def test_the_cut_keeps_spans_that_start_in_the_window_and_end_before_the_first_traced_call(log):
    http = [11, 12, 13, 14, 15]
    assert [s.id for s in spans.untraced(_run(traced_at=20.2))] == [2, 3, 4, 5, 6, 7] + http
    assert [s.id for s in spans.untraced(_run(traced_at=20.55))] == \
        [2, 3, 4, 5, 6, 7, 8] + http + [17]
    assert [s.id for s in spans.untraced(_run())] == list(range(2, 19))


@pytest.mark.parametrize("name", READERS)
def test_a_p50_copy_reads_as_its_original(log, name):
    r = _run(traced_at=30.0)
    assert spec.reader(HOME, name + ".p50")(r) == spec.reader(HOME, name)(r)


@pytest.mark.parametrize("name", ALL)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(spans, "_snapshot", lambda: None)
    assert spec.reader(HOME, name)(_run()) is None


def test_a_tiny_cpu_run_is_read(tmp_path):
    """A whole CPU run of a tiny serving cell at a low rate (three
    requests, seconds apart): the readers find the program's spans of the
    window and read numbers, except the card's time. A request that meets
    an idle batcher with none on its way is dispatched at once: the Batcher
    never waits out its window, and the median wait is far under it."""
    root = make_tree(tmp_path)
    keep = {}
    cell = spec.load("tiny.lowrate", root)
    res = run.run_cell(cell, 2 ** 31 + 91, 6.0, False, device="cpu", t_start=0.0, keep=keep)
    assert res["correct"], res["checked"]
    got = {m: spec.reader(HOME, m)(keep["run"]) for m in ALL}
    batcher = keep["run"].counters["batcher"]
    assert batcher["after"]["window_waits"] - batcher["before"]["window_waits"] == 0
    assert got["serve.queue_median_ms"] < cell.workload["server"]["window_ms"] / 3
    assert got["serve.queue_wait_ms"] > 0
    assert got["serve.http_ms"] > 0
    assert got["inference.host_ms"] > 0
    assert 0.0 <= got["decode.pad_share"] < 100.0
    assert got["decode.device_ms_per_audio_s"] is None  # no card
