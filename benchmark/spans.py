"""The program's spans over the untraced part of the window, for the
per-layer readers that read them (`metrics/serve.queue_wait_ms.py`,
`inference.host_ms.py`, `decode.*.py`).

The program records spans in-process (`styletts2_tpu_torch.observability.
spans`: `time.monotonic_ns()` intervals with ids, parents, request ids and
attributes; the span names are listed in `serve.py` and `inference.py`).
Kept here: the spans that start at or after the window opens and end
before the first traced call starts (`run.calls[i]["t0"]` of the first
with `traced`; the window's end if none was traced), so that no reading
holds the profiler's start or its stall of the serving thread. A program
without the recorder yields None, and so its readers.
"""

from __future__ import annotations

from typing import List, Optional

FRAMES_PER_S = 24000 / 600  # aligned frames a second of audio: 24 kHz, 600 samples a frame


def _snapshot() -> Optional[list]:
    try:
        from styletts2_tpu_torch.observability import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.snapshot()


def untraced(run) -> Optional[List]:
    """The spans inside the window's untraced part (module docstring)."""
    got = _snapshot()
    if got is None:
        return None
    lo, hi = run.window
    cut = min((c["t0"] for c in run.calls if c.get("traced")), default=hi)
    lo_ns, cut_ns = lo * 1e9, cut * 1e9
    return [s for s in got if s.start_ns >= lo_ns and s.end_ns is not None
            and s.end_ns < cut_ns]


def named(spans: List, name: str) -> List:
    return [s for s in spans if s.name == name]


def children(spans: List, parents: List, name: str) -> dict:
    """{parent id: [its children named `name`]} for each of `parents`."""
    out = {p.id: [] for p in parents}
    for s in spans:
        if s.name == name and s.parent in out:
            out[s.parent].append(s)
    return out
