"""A training log and `metrics.jsonl` (`styletts2_tpu/observability.py`):
`get_logger` writes `train.log` in the log directory and INFO lines to the
console; `MetricsWriter` appends one JSON line per record."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


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
    """Appends {"step", "ts", **scalars} lines to `metrics.jsonl`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, values: Dict[str, float], step: int) -> None:
        rec = {"step": step, "ts": time.time(), **{k: float(v) for k, v in values.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
