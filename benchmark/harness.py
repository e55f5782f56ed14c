"""What every entry (`entries/<name>.py`) shares: the profiler over a slice
of the window, the end-to-end arithmetic, the device's record, the trace's
breakdown, the result's schema and the check for forbidden modules.

An entry marks each timed unit of work (a synthesis call, a training
step) with a `record_function("bench.call")` block: the traced slice, its
busy time and its breakdown are read between the first and the last.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from benchmark import spec, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "styletts2_tpu")
# the traced slice: from 30% of the window, ~2 s of calls or 12 calls, whichever ends first
TRACE_AT, TRACE_S, TRACE_CALLS = 0.3, 2.0, 12
CALL = "bench.call"  # the span an entry opens around each timed unit of work


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Tracer:
    """The profiler over a slice of the window, started and stopped at call
    boundaries on the thread that calls the program."""

    def __init__(self, on: bool):
        self.on, self.prof, self.state = on, None, "wait"
        self.start_at = math.inf
        self.t_start = None
        self.calls = 0

    def before(self) -> bool:
        if self.on and self.state == "wait" and time.monotonic() >= self.start_at:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                           torch.profiler.ProfilerActivity.CUDA])
            t = time.monotonic()
            self.prof.start()
            self.state, self.t_start = "tracing", time.monotonic()
            self.start_s = self.t_start - t
        self.calls += self.state == "tracing"
        return self.state == "tracing"

    def after(self, t1: float) -> None:
        if self.state == "tracing" and (t1 >= self.t_start + TRACE_S or self.calls >= TRACE_CALLS):
            self.stop()

    def stop(self) -> None:
        if self.state == "tracing":
            torch.cuda.synchronize()
            self.prof.stop()
            self.state = "done"

    def events(self) -> Optional[list]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def load_cupti(dev: torch.device) -> None:
    """The profiler's first start loads CUPTI: done in set-up, not inside the window."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()


def end_to_end(requests: List[dict], end: float, seconds: float) -> Dict[str, float]:
    """The latency percentiles of every request (from when it was due, or
    sent, to its last byte; one that failed or never finished ranks above
    all) and the seconds of audio answered inside the window per second. A
    step-based entry passes its steps as requests: a step's wall time is
    its latency, the audio it stepped over its audio."""
    lat = [(q["done"] - q["start"]) * 1e3 if q["ok"] else None for q in requests]
    audio = sum(q["audio_s"] for q in requests if q["ok"] and q["done"] <= end)
    return {"latency_p50_ms": yardstick.percentile(lat, 50),
            "latency_p95_ms": yardstick.percentile(lat, 95),
            "audio_s_per_s": audio / seconds}


def _calls(events: list) -> List[dict]:
    return [e for e in events if e.get("name") == CALL and e.get("cat") == "user_annotation"]


def device_info(dev: torch.device, peak: int, events: Optional[list] = None) -> dict:
    """The result's `device`; with a trace, the busy seconds between the
    first and the last traced call's start and end, and that window."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": peak}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    if events is not None:
        win = _calls(events)
        merged = yardstick.intervals(events)
        a = min(e["ts"] for e in win) if win else 0.0
        b = max(e["ts"] + e["dur"] for e in win) if win else 0.0
        out["busy_s"] = yardstick.busy_within(merged, a, b) / 1e6
        out["window_s"] = (b - a) / 1e6
    return out


def breakdown(events: list) -> dict:
    """The slice's device operations that took most time, and its longest
    idle gaps by what the host was doing (the innermost host span on the
    calling thread at the gap's middle; outside a call: waiting for work)."""
    calls = _calls(events)
    if not calls:
        return {"device_ops": [], "idle_gaps": []}
    a = min(e["ts"] for e in calls)
    b = max(e["ts"] + e["dur"] for e in calls)
    ops: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in yardstick.DEVICE_WORK and a <= e["ts"] <= b:
            ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    tid = calls[0]["tid"]
    host = sorted((e for e in events if e.get("tid") == tid and e.get("ph") == "X"
                   and e.get("cat") in ("user_annotation", "cpu_op", "cuda_runtime")),
                  key=lambda e: e["ts"])
    gaps: Dict[str, float] = {}
    merged = yardstick.intervals(events)
    prev = a
    for lo, hi in merged + [(b, b)]:
        lo, hi = min(max(lo, a), b), min(hi, b)  # work after the slice's end leaves no gap
        if lo > prev:
            mid = (prev + lo) / 2
            inner = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            label = min(inner, key=lambda e: e["dur"])["name"] if inner else "host: between calls"
            gaps[label] = gaps.get(label, 0.0) + (lo - prev) / 1e6
        prev = max(prev, hi)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def result(cell: spec.Cell, trace: bool, run: Any, *, correct: bool, attempted: int,
           failed: int, e2e: Dict[str, float], dev: torch.device, peak: int,
           numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """The result line: with --trace 0 the cell's end-to-end metrics from
    `e2e`, with --trace 1 its per-layer metrics as each reader reads `run`
    (one that reads None is left out); `device`, the trace's `breakdown`,
    and last each number compared beside its limit."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {}}
    if not trace:
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.reader(cell.home, m["name"])(run)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    events = run.trace if trace else None
    out["device"] = device_info(dev, peak, events)
    if events is not None:
        out["breakdown"] = breakdown(events)
    out["checked"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
