"""Finds a cell's pieces by name: its entry in BENCHMARK.json, its
configuration file, its traffic file (`<paths[0]>/workloads/<cell>.json`),
the harness that runs it (`<paths[0]>/entries/<harness>.py`, named by the
configuration file's `harness` key, `synthesis` where it names none: a
function `run_cell(cell, seed, seconds, trace, device, t_start, keep)`
that returns the result, `harness.result`) and each per-layer metric's
reader (`<paths[0]>/metrics/<metric>.py`, a function `read(run)` that
returns a number, or None where it finds nothing to read). Adding a
configuration with its own entry and plain reference, a mix or a metric
adds files and entries and edits none."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_HARNESS = "synthesis"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    workload: dict  # the traffic file
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # and with --trace 1
    home: Path  # the benchmark's directory (paths[0])
    harness: str  # the entry, `home/entries/<harness>.py`


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    home = root / bench["paths"][0]
    config = json.loads((root / conf["file"]).read_text())
    return Cell(name, int(w["chips"]), config,
                json.loads((home / "workloads" / f"{name}.json").read_text()),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], home,
                config.get("harness", DEFAULT_HARNESS))


@functools.lru_cache(maxsize=None)
def _module(path: Path, name: str):
    """The module of `path`, executed once a process."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(home: Path, metric: str) -> Callable:
    return _module(home / "metrics" / f"{metric}.py",
                   f"benchmark_metric_{metric.replace('.', '_')}").read


def entry_module(home: Path, harness: str):
    """The module `home/entries/<harness>.py` (an entry's own tools, such as
    the synthesis entry's `sweep`, are found there)."""
    return _module(home / "entries" / f"{harness}.py",
                   f"benchmark_entry_{harness.replace('.', '_')}")


def entry(home: Path, harness: str) -> Callable:
    """The `run_cell` of `home/entries/<harness>.py`."""
    return entry_module(home, harness).run_cell
