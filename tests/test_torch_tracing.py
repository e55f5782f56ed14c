"""The port's spans (`observability.spans`): the tree one CPU synthesis call
records (`inference.py`), the serve spans of concurrent POSTs through a
`TTSServer` (`serve.py`), one clock with a profiler's trace, recording
switched off, and the ring's bound. It imports neither JAX nor the JAX
package.
"""

import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.observability import Spans, spans
from styletts2_tpu_torch.serve import TTSServer
from test_torch_serve import FakeSynthesizer, _post

torch.set_num_threads(1)  # the suite runs in several worker processes on a few cores

TEXTS = ["ðɪs ɪz ɐ tˈɛst.", "sˈɛkənd lˈaɪn ɪz lˈɔŋɡɚ ðɐn ðə fˈɜːst."]
STAGES = {"inference_batch": ["phase_a"], "inference": ["text", "style", "duration"]}


@pytest.fixture(scope="module")
def syn():
    from styletts2_tpu_torch.inference import Synthesizer

    cfg = Config()
    cfg.plbert_params.num_hidden_layers = 1
    cfg.plbert_params.hidden_size = 64
    cfg.plbert_params.intermediate_size = 128
    cfg.plbert_params.num_attention_heads = 2
    cfg.model_params.hidden_dim = 64
    cfg.model_params.style_dim = 32
    cfg.model_params.dim_in = 16
    cfg.model_params.diffusion.transformer.num_layers = 1
    cfg.model_params.decoder.upsample_initial_channel = 64
    return Synthesizer(cfg, seed=0, device="cpu")


@pytest.fixture
def recorder():
    spans.clear()
    spans.enabled = True
    yield spans
    spans.enabled = True
    spans.clear()


def _call(syn, entry):
    """(the waveforms, the frames each answers) of one call of `entry`."""
    kw = dict(diffusion_steps=3, speed=4.0, seed=1)
    if entry == "inference_batch":
        wavs = syn.inference_batch(TEXTS, **kw)
        return wavs, [len(w) // 600 for w in wavs]
    r = syn.synthesize(TEXTS[1], **kw)
    return [r.wav], [int(r.pred_dur.sum())]


@pytest.mark.parametrize("entry", sorted(STAGES))
def test_a_call_records_its_span_tree(syn, recorder, entry):
    """One CPU call is one `inference.call`, a request of its own, holding
    its stages, the two waits (the copies) and the rounding in order, each
    with the call's request id; its frames are those answered and decoded;
    no stage has a device time on the CPU."""
    _, frames = _call(syn, entry)
    got = recorder.snapshot()
    (call,) = [s for s in got if s.name == "inference.call"]
    assert call.parent is None and call.request is not None
    assert {s.request for s in got} == {call.request}
    children = sorted((s for s in got if s.parent == call.id), key=lambda s: s.start_ns)
    stages = STAGES[entry]
    assert [s.name for s in children] == stages + [
        "inference.wait", "inference.round", "prosody", "decode", "inference.wait"]
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in children)
    B = len(frames)
    a = call.attrs
    assert (a["B"], a["T"]) == (B, 64)
    assert a["frames_answered"] == sum(frames)
    assert a["n_frames"] % 100 == 0 and a["n_frames"] >= max(frames)
    assert a["frames_decoded"] == B * a["n_frames"]
    for s in children:
        if s.name in stages + ["prosody", "decode"]:
            assert "device_ms" in s.attrs and s.attrs["device_ms"] is None


@pytest.mark.parametrize("entry", sorted(STAGES))
def test_recording_off_records_nothing_and_changes_no_output(syn, recorder, entry):
    on, _ = _call(syn, entry)
    assert recorder.snapshot()
    recorder.clear()
    recorder.enabled = False
    off, _ = _call(syn, entry)
    assert recorder.snapshot() == []
    assert len(on) == len(off) and all(np.array_equal(a, b) for a, b in zip(on, off))


def _serve_four(window_ms=200.0):
    """Four concurrent POST /tts to a TTSServer over a FakeSynthesizer:
    (the answers, the batcher's stats)."""
    server = TTSServer(FakeSynthesizer(), max_batch=8, window_ms=window_ms)
    port = server.start_background()
    try:
        results = {}

        def go(i):
            results[i] = _post(port, {"text": f"text number {i}."})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
        return results, dict(server.batcher.stats)
    finally:
        server.close()


def test_serve_spans_of_concurrent_posts(recorder):
    """Each request's parse, queue and encode lie in its `serve.request`,
    which has its status, one after another; each `serve.queue` ends within 1 ms of
    the start of the batch that took it, whose ids agree with
    `Batcher.stats`; the worker records its idle and window spans."""
    results, stats = _serve_four()
    assert all(code == 200 for code, _, _ in results.values())
    got = recorder.snapshot()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    reqs = by["serve.request"]
    assert len(reqs) == 4
    for r in reqs:
        kids = {s.name: s for s in got if s.parent == r.id}
        assert set(kids) == {"serve.parse", "serve.queue", "serve.encode"}
        assert all(s.request == r.request for s in kids.values())
        assert r.attrs["status"] == 200
        parse, queued, encode = (kids[n] for n in ("serve.parse", "serve.queue", "serve.encode"))
        assert r.start_ns <= parse.end_ns <= queued.start_ns
        assert queued.end_ns <= encode.start_ns <= encode.end_ns <= r.end_ns
    batches = {s.attrs["batch"]: s for s in by["serve.batch"]}
    assert sorted(batches) == list(range(1, stats["batches"] + 1))
    assert sum(b.attrs["B"] for b in batches.values()) == stats["requests"] == 4
    assert sorted(i for b in batches.values() for i in b.attrs["requests"]) == \
        sorted(r.request for r in reqs)
    for q in by["serve.queue"]:
        b = batches[q.attrs["batch"]]
        assert q.request in b.attrs["requests"]
        assert abs(q.end_ns - b.start_ns) <= 1_000_000
    assert by["serve.idle"] and by["serve.window"]
    worker = {s.thread for s in by["serve.batch"] + by["serve.idle"] + by["serve.window"]}
    assert len(worker) == 1 and worker.isdisjoint(r.thread for r in reqs)


def test_serve_span_of_a_refused_post(recorder):
    """A POST the server refuses has its status in its `serve.request`, and
    no queue or encode span."""
    server = TTSServer(FakeSynthesizer(), max_batch=8, window_ms=5.0)
    port = server.start_background()
    try:
        code, _, _ = _post(port, {"text": "hello.", "voice": "nobody"})
    finally:
        server.close()
    assert code == 400
    got = recorder.snapshot()
    (r,) = [s for s in got if s.name == "serve.request"]
    assert r.attrs["status"] == 400
    assert [s.name for s in got if s.parent == r.id] == ["serve.parse"]


def test_spans_share_one_clock_with_the_profiler_trace(syn, recorder):
    """A profiler started on a thread other than the main one (it traces the
    thread it starts on, as the benchmark's does on the batcher's worker)
    holds each span of a synthesis call there as an event of its name on
    that thread, and one offset maps each span's start onto its event's
    within 200 us (after a first block on the thread, which takes longer)."""
    from torch.profiler import ProfilerActivity, profile

    traced = {}

    def run():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm-up"):  # the thread's first block is slow
                pass
            _call(syn, "inference_batch")
        traced["prof"] = prof

    th = threading.Thread(target=run)
    th.start()
    th.join(120)
    assert not th.is_alive()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        traced["prof"].export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    got = recorder.snapshot()
    assert len(got) == 7 and len({s.thread for s in got}) == 1
    assert got[0].thread != threading.get_native_id()
    pairs = []
    for name in {s.name for s in got}:
        mine = sorted((s for s in got if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e.get("name") == name and e.get("ph") == "X"),
                        key=lambda e: e["ts"])
        assert len(theirs) == len(mine), (name, len(theirs), len(mine))
        assert all(e["tid"] == s.thread for s, e in zip(mine, theirs))
        pairs += zip(mine, theirs)
    offsets = np.array([e["ts"] - s.start_ns / 1e3 for s, e in pairs])
    offset = float(np.median(offsets))
    assert np.abs(offsets - offset).max() <= 200.0, np.abs(offsets - offset).max()


def test_a_span_open_while_a_profiler_starts_and_stops_ends_cleanly(recorder):
    """The benchmark starts and stops its profiler inside a `serve.batch`
    span: a span open across the start, and one across the stop, end and
    are recorded; the trace holds the spans opened while it ran."""
    from torch.profiler import ProfilerActivity, profile

    across_start = recorder.span("across_start").__enter__()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with recorder.span("inside"):
        torch.ones(2).add_(1)
    across_stop = recorder.span("across_stop").__enter__()
    across_start.__exit__(None, None, None)
    prof.stop()
    across_stop.__exit__(None, None, None)
    assert [s.name for s in recorder.snapshot()] == ["inside", "across_start", "across_stop"]
    assert recorder.current() is None
    names = {e.name for e in prof.events()}
    assert "inside" in names and "across_start" not in names


def test_the_ring_keeps_the_last_spans():
    ring = Spans(capacity=8)
    for i in range(20):
        with ring.span("s", i=i):
            pass
    got = ring.snapshot()
    assert [s.attrs["i"] for s in got] == list(range(12, 20))
    assert [s.id for s in got] == sorted(s.id for s in got)
