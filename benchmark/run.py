"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

The cell's configuration and traffic are found by name (`spec`), and so
is its entry: the `harness` that its configuration file names
(`entries/<harness>.py`), the synthesis entry where it names none. The
entry sets the cell up from the seed, runs its window of S seconds, judges
what the window produced against its plain reference and returns the
result (`harness.result`); the last line of standard output is that
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fixed_caches(root: Path) -> None:
    """Every kernel cache inside the checkout, at fixed paths (K1's nvcc
    build goes to the program's own styletts2_tpu_torch/_build/)."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


_fixed_caches(ROOT)

import torch  # noqa: E402

from benchmark import harness, spec  # noqa: E402
from benchmark.harness import log  # noqa: E402


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, keep: Optional[dict] = None) -> dict:
    """One run of `cell` by its entry."""
    entry = spec.entry(cell.home, cell.harness)
    return entry(cell, seed, seconds, trace, device, t_start, keep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}")
        return 3
    for k, v in result["checked"].items():
        log(f"checked {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
