"""The control of the comparison that decides `correct`: the reference put in
the program's place, computed with TF32 on (the precision below the
configurations' f32 with TF32 off), judged as a run judges the program.

    python3 -m benchmark.control --workload CELL --seconds S --seeds N [N ...]

Each seed is one run of the cell (set-up, a window of S seconds at the
cell's load, so that the drawn calls are the batches the server formed),
whose drawn calls' answers are replaced by the TF32 reference's. Prints
one JSON line per seed with the numbers compared; a sound control reads
`correct: false`. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run  # noqa: F401  (fixes the kernel caches on import)
from benchmark import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    if cell.harness != spec.DEFAULT_HARNESS:
        print(f"{args.workload}: this is the synthesis entry's control; an entry of its own "
              "brings its own", file=sys.stderr)
        return 2
    entry = spec.entry(cell.home, cell.harness)
    for seed in args.seeds:
        res = entry(cell, seed, args.seconds, False, "cuda", time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "checked": res["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
