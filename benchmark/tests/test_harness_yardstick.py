"""The benchmark's arithmetic: percentiles with failures, audio per
second, the busy time and breakdown of a hand-made trace, FLOPs and K1's
bytes against the reference."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spec, yardstick
from benchmark.reference.model import Reference, param_specs
from benchmark.tests.tiny import tiny_config
from benchmark.weights import make


def test_percentile_ranks_failures_above_every_answer():
    lat = [float(v) for v in range(1, 101)]
    assert yardstick.percentile(lat, 50) == 50.0
    assert yardstick.percentile(lat, 95) == 95.0
    assert yardstick.percentile(lat + [None] * 4, 95) == 99.0  # 104 samples: rank 99
    assert yardstick.percentile(lat[:90] + [None] * 10, 95) == math.inf
    assert yardstick.percentile([None, 3.0], 50) == 3.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)


def test_spread_is_the_quartile_distance_over_the_median():
    from benchmark import spreads

    assert spreads.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)
    assert spreads.trimmed([1.0, 2.0, 3.0, 9.0]) == [1.0, 2.0, 3.0]
    runs = [{"metrics": {"m": {"value": v}}} for v in (10.0, 11.0, 12.0, 10.0, 11.0, 12.0)]
    row = spreads.table([runs, runs])["m"]
    assert row["medians"] == [11.0, 11.0] and row["bound_5x"] == pytest.approx(5 * 2.0 / 11.0)


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0.0, "dur": 100.0, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": "decode", "ts": 50.0, "dur": 40.0, "tid": 7},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 92.0, "dur": 8.0, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 200.0, "dur": 50.0, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 10.0, "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 20.0, "dur": 30.0},  # overlaps k_a
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60.0, "dur": 20.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "decode", "ts": 50.0, "dur": 40.0},
          {"ph": "X", "cat": "kernel", "name": "adain_snake_kernel<float>", "ts": 210.0, "dur": 30.0}]
    return ev


def test_device_busy_counts_overlaps_once_and_no_spans():
    ev = _trace()
    assert yardstick.device_busy_ms(ev) == pytest.approx((40 + 20 + 30) / 1e3)
    merged = yardstick.intervals(ev)
    assert merged == [(10.0, 50.0), (60.0, 80.0), (210.0, 240.0)]
    assert yardstick.busy_within(merged, 0.0, 100.0) == 60.0


def test_breakdown_and_idle_of_a_hand_made_trace():
    after = {"ph": "X", "cat": "kernel", "name": "k_after", "ts": 300.0, "dur": 10.0}
    r = SimpleNamespace(trace=_trace() + [after])  # work after the last call: no gap, no op
    bd = harness.breakdown(r.trace)
    assert bd["device_ops"] == [["k_a", 30e-6], ["k_b", 30e-6],
                                ["adain_snake_kernel<float>", 30e-6], ["Memcpy DtoH", 20e-6]]
    # idle: 0-10 and 240-250 inside a call outside any finer span, 50-60 in
    # "decode", 80-210 between the calls
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"host: between calls": 130e-6, "bench.call": 20e-6, "decode": 10e-6})
    idle = spec.reader(spec.ROOT / "benchmark", "inference.device_idle")(r)
    assert idle == pytest.approx(100.0 * (1 - (40.0 + 20.0 + 30.0) / 150.0))


def test_end_to_end_counts_failures_and_audio_inside_the_window():
    reqs = [{"start": float(i), "done": i + 0.1 * (i + 1), "ok": True, "audio_s": 2.0}
            for i in range(18)]
    reqs += [{"start": 3.0, "done": None, "ok": False, "audio_s": 0.0},
             {"start": 19.0, "done": 20.5, "ok": True, "audio_s": 5.0}]  # answered after the window
    e2e = harness.end_to_end(reqs, end=20.0, seconds=20.0)
    assert e2e["audio_s_per_s"] == pytest.approx(18 * 2.0 / 20.0)
    lat = sorted([100.0 * (i + 1) for i in range(18)] + [1500.0])
    assert e2e["latency_p50_ms"] == pytest.approx(lat[9])  # rank 10 of 20
    assert e2e["latency_p95_ms"] == pytest.approx(lat[18])  # rank 19: the late answer
    reqs[0]["ok"] = False
    assert harness.end_to_end(reqs, 20.0, 20.0)["latency_p95_ms"] == math.inf


@pytest.fixture(scope="module")
def tiny_ref():
    torch.manual_seed(0)
    out = {}
    for ms in (False, True):
        cfg = tiny_config(ms)
        out[ms] = Reference(cfg, make(param_specs(cfg), 3, "cpu"))
    return out


@pytest.mark.parametrize("ms", [False, True])
def test_flop_model_equals_flop_counter_at_other_shapes(tiny_ref, ms):
    ref = tiny_ref[ms]
    model = yardstick.FlopModel.fit(ref)
    for L, F in ((13, 17), (33, 25)):
        assert model(L, F) == pytest.approx(yardstick.count_reference(ref, L, F), rel=1e-9)


@pytest.mark.parametrize("ms", [False, True])
@pytest.mark.parametrize("frames", [7, 20])
def test_k1_bytes_from_the_sites_the_decoder_sees(tiny_ref, ms, frames):
    ref = tiny_ref[ms]
    ref.k1_sites = []
    with torch.inference_mode():
        sd = ref.sdim
        H = ref.mp["hidden_dim"]
        asr = torch.zeros(1, H, frames)
        f0 = torch.zeros(1, 2 * frames)
        ref.decode(asr, f0, f0, torch.zeros(1, sd), None)
    sites, ref.k1_sites = ref.k1_sites, None
    assert sites == yardstick.k1_sites(ref.cfg, frames)
    assert len(sites) == (4 if ms else 2) * (1 + 2) * 3 * 2  # stages x (noise + 2 resblocks) x 3 dilations x 2
    assert yardstick.k1_bytes(ref.cfg, frames) == sum(4 * (2 * C * T + 3 * C) for C, T in sites)
