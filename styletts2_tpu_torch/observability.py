"""A training log, `metrics.jsonl`, the eval artifacts and the step meters
(`styletts2_tpu/observability.py`): `get_logger` writes `train.log` in the
log directory and INFO lines to the console; `MetricsWriter` appends one
JSON line per record and writes eval audio as WAV files and attention maps
as .npy files beside it (no TensorBoard, no matplotlib). `StepTimer` is an
EMA step meter, `trace` a torch.profiler trace written as a Chrome trace,
`device_busy_ms` reads the card's busy time from one, and `nan_check`
names the non-finite leaves of nested metrics or tensors.

`spans` is the process's span recorder (`Spans`): the server and the
Synthesizer record each request's path through them as spans, raw
`time.monotonic_ns()` intervals with ids, parents and attributes, into a
bounded ring that a reader copies with `spans.snapshot()`. The names are
listed where they are recorded (`serve.py`, `inference.py`); they are the
readers' contract."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from styletts2_tpu_torch.utils import write_wav

# whether a profiler records this thread's operations (a profiler traces the
# thread it was started on): far cheaper than a record_function block
_profiling = torch._C._autograd._profiler_enabled


def get_logger(log_dir: str, name: str = "styletts2_tpu_torch", rank: int = 0) -> logging.Logger:
    """The run's logger: `train.log` in `log_dir` and INFO to the console;
    for a data-parallel rank other than 0, warnings to the console alone."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in list(logger.handlers):  # one run's log per directory
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler()
    if rank:
        sh.setLevel(logging.WARNING)
        sh.setFormatter(logging.Formatter(f"rank {rank}: %(levelname)s: %(message)s"))
        logger.addHandler(sh)
        return logger
    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.abspath(os.path.join(log_dir, "train.log")))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(levelname)s:%(asctime)s: %(message)s"))
    sh.setLevel(logging.INFO)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricsWriter:
    """Appends {"step", "ts", **scalars} lines to `metrics.jsonl`; `audio`
    writes `eval_audio/{tag}_step{step}.wav` and `attention`
    `eval_attn/attn_step{step}.npy` in the same directory (a tag's "/"
    becomes "_"). Not `enabled` (a data-parallel rank other than 0), it
    writes nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir, self.enabled = log_dir, enabled
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, values: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "ts": time.time(), **{k: float(v) for k, v in values.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def _path(self, sub: str, name: str) -> str:
        d = os.path.join(self.log_dir, sub)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def audio(self, tag: str, wav, step: int) -> None:
        """A 24 kHz eval waveform as `eval_audio/{tag}_step{step}.wav`."""
        if not self.enabled:
            return
        path = self._path("eval_audio", f"{tag.replace('/', '_')}_step{step}.wav")
        write_wav(path, np.asarray(wav, np.float32).ravel(), 24000)

    def attention(self, attn, step: int) -> None:
        """An attention map as `eval_attn/attn_step{step}.npy`."""
        if self.enabled:
            np.save(self._path("eval_attn", f"attn_step{step}.npy"), np.asarray(attn, np.float32))

    def close(self) -> None:
        if self.enabled:
            self._f.close()


class StepTimer:
    """Wall-clock step meter: `stop` returns the step's seconds since
    `start`; `avg` is their EMA (weight `ema` on the past)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """A torch.profiler trace of the enclosed code, CPU activity and, where a
    CUDA device is present, the card's, written to
    `log_dir/trace_{time}.json` (Chrome trace format)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


class Span:
    """One recorded interval: `id`, `parent` (the id of the span it lies
    in, or None), `request` (the id of the request it serves, or None),
    `name`, `thread` (the native id of the thread it started on), `start_ns`
    and `end_ns` (`time.monotonic_ns()`; `end_ns` None while open) and
    `attrs`, which `set` adds to. Used as a context manager (`Spans.span`),
    it is the innermost open span of its thread and, where a profiler
    records the thread as it opens, a `torch.profiler.record_function`
    block of its name."""

    __slots__ = ("id", "parent", "request", "name", "thread", "start_ns", "end_ns", "attrs",
                 "_owner", "_stack", "_frame")

    def __init__(self, owner: "Spans", stack: list, name: str, parent: Optional["Span"],
                 request: Optional[int], attrs: dict):
        self._owner, self._stack, self._frame = owner, stack, None
        self.id = next(owner._ids)
        if parent is None:
            self.parent, self.request = None, request
        else:
            self.parent = parent.id
            self.request = parent.request if request is None else request
        self.name, self.attrs = name, attrs
        self.thread = threading.get_native_id()
        self.end_ns = None
        self.start_ns = time.monotonic_ns()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._stack.append(self)
        if _profiling():
            self._frame = record_function(self.name)
            self._frame.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._frame is not None:
            self._frame.__exit__(*exc)
        self._stack.pop()
        self._owner.end(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {self.start_ns}-{self.end_ns}, {self.attrs})")


class _Off:
    """What `Spans` hands out while it records nothing."""

    id = parent = request = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


OFF = _Off()


class Spans:
    """The span recorder: finished spans go into a ring of the last
    `capacity`; recording takes no lock (the ring's append and the id
    counter are atomic in CPython), makes no device call and does no I/O.
    It computes nothing from what it records: readers do.

    `span(name, ...)` is a span over a `with` block; a span that is not
    entered ends at `end(span)`, on any thread (it is on no thread's stack
    and not in a profiler's trace). A span's parent is the innermost open
    span on its thread unless `parent` is given; its request id is the
    parent's unless `request` is given (`new_request()` draws one).
    `enabled = False` records nothing; `snapshot()` copies the ring, oldest
    first (by end)."""

    def __init__(self, capacity: int = 1 << 17):
        self.enabled = True
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def current(self) -> Optional[Span]:
        """The innermost open span on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def new_request(self) -> int:
        return next(self._ids)

    def span(self, name: str, parent: Optional[Span] = None, request: Optional[int] = None,
             **attrs):
        if not self.enabled:
            return OFF
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        return Span(self, stack, name, parent, request, attrs)

    def end(self, span, **attrs) -> None:
        if span is OFF:
            return
        if attrs:
            span.attrs.update(attrs)
        span.end_ns = time.monotonic_ns()
        self._ring.append(span)

    def snapshot(self) -> List[Span]:
        while True:
            try:
                return list(self._ring)
            except RuntimeError:  # appended to while copied
                continue

    def clear(self) -> None:
        self._ring.clear()


spans = Spans()


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device categories


def device_busy_ms(events) -> float:
    """The card's busy time (ms) in a Chrome trace's `traceEvents`: the
    union of its kernels', copies' and memsets' intervals over every
    stream, so that kernels overlapping on two streams count once (the
    record_function spans the trace also places on the device are not
    work). Over the wall of the traced call it is the device's busy
    share."""
    busy, reach = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in DEVICE_WORK):
        busy += max(b - max(a, reach), 0.0)
        reach = max(reach, b)
    return busy / 1e3


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def nan_check(tree, logger: Optional[logging.Logger] = None) -> bool:
    """Whether every leaf of nested dicts, lists and tuples of tensors, arrays
    and numbers is finite; the paths of the others go to `logger` (the
    first 10)."""
    bad = []
    for path, leaf in _leaves(tree):
        finite = (bool(torch.isfinite(leaf).all()) if torch.is_tensor(leaf)
                  else bool(np.isfinite(np.asarray(leaf, np.float64)).all()))
        if not finite:
            bad.append(path)
    if bad and logger:
        logger.error(f"non-finite values in: {bad[:10]}")
    return not bad
