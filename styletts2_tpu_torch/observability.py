"""A training log, `metrics.jsonl` and the eval artifacts
(`styletts2_tpu/observability.py`): `get_logger` writes `train.log` in the
log directory and INFO lines to the console; `MetricsWriter` appends one
JSON line per record and writes eval audio as WAV files and attention maps
as .npy files beside it (no TensorBoard, no matplotlib)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np

from styletts2_tpu_torch.utils import write_wav


def get_logger(log_dir: str, name: str = "styletts2_tpu_torch") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    path = os.path.abspath(os.path.join(log_dir, "train.log"))
    for h in list(logger.handlers):  # one run's log per directory
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(path)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(levelname)s:%(asctime)s: %(message)s"))
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class MetricsWriter:
    """Appends {"step", "ts", **scalars} lines to `metrics.jsonl`; `audio`
    writes `eval_audio/{tag}_step{step}.wav` and `attention`
    `eval_attn/attn_step{step}.npy` in the same directory (a tag's "/"
    becomes "_")."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, values: Dict[str, float], step: int) -> None:
        rec = {"step": step, "ts": time.time(), **{k: float(v) for k, v in values.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def _path(self, sub: str, name: str) -> str:
        d = os.path.join(self.log_dir, sub)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def audio(self, tag: str, wav, step: int) -> None:
        """A 24 kHz eval waveform as `eval_audio/{tag}_step{step}.wav`."""
        path = self._path("eval_audio", f"{tag.replace('/', '_')}_step{step}.wav")
        write_wav(path, np.asarray(wav, np.float32).ravel(), 24000)

    def attention(self, attn, step: int) -> None:
        """An attention map as `eval_attn/attn_step{step}.npy`."""
        np.save(self._path("eval_attn", f"attn_step{step}.npy"), np.asarray(attn, np.float32))

    def close(self) -> None:
        self._f.close()
