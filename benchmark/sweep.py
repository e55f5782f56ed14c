"""The knee of an open-loop cell, and how steady each rate below it reads:
after one set-up, `--repeats` windows at each of several fixed rates (the
synthesis entry's `sweep`), each window's latency percentiles, audio
answered per second, batch mean and whether the queue grew (the later
half's median latency over the earlier half's); then, a rate, the spread
of each over its windows as `spreads.py` takes it.

    python3 -m benchmark.sweep --workload CELL --seconds S --rates R [R ...] [--repeats N]

The highest rate whose p95 stays within a few batches' time and whose
queue does not grow is the knee. A cell's file offers the highest rate
whose windows' spreads stay under half of each bound in BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from benchmark import run  # noqa: F401  (fixes the kernel caches on import)
from benchmark import spec, spreads

SPREAD_OF = ("latency_p50_ms", "latency_p95_ms", "audio_s_per_s", "batch_mean")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7_000_000_000)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if cell.harness != spec.DEFAULT_HARNESS or cell.workload["load"]["kind"] != "open":
        print(f"{args.workload}: the sweep takes an open-loop cell of the synthesis entry",
              file=sys.stderr)
        return 2
    sweep = spec.entry_module(cell.home, cell.harness).sweep
    by_rate = {}
    for w in sweep(cell, args.seed, args.seconds, args.rates, args.repeats):
        print(json.dumps(w), flush=True)
        by_rate.setdefault(w["rate_per_s"], []).append(w)
    for rate, ws in by_rate.items():
        if len(ws) < 3:
            continue
        out = {"rate_per_s": rate, "windows": len(ws)}
        for m in SPREAD_OF:
            v = [w[m] for w in ws]
            out[m] = {"median": statistics.median(v), "spread": spreads.spread(v),
                      "trimmed": spreads.spread(spreads.trimmed(v))}
        print(json.dumps({"summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
