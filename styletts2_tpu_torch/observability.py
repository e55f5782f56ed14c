"""A training log, `metrics.jsonl`, the eval artifacts and the step meters
(`styletts2_tpu/observability.py`): `get_logger` writes `train.log` in the
log directory and INFO lines to the console; `MetricsWriter` appends one
JSON line per record and writes eval audio as WAV files and attention maps
as .npy files beside it (no TensorBoard, no matplotlib). `StepTimer` is an
EMA step meter, `trace` a torch.profiler trace written as a Chrome trace,
`device_busy_ms` reads the card's busy time from one, and `nan_check`
names the non-finite leaves of nested metrics or tensors."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from styletts2_tpu_torch.utils import write_wav


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
