"""The knee of an open-loop cell: the cell at several fixed rates, one run
each (a fresh seed, the cell's own set-up), reporting the latency
percentiles, the audio answered per second, and whether the queue grew
(the later half's median latency over the earlier half's).

    python3 -m benchmark.sweep --workload CELL --seconds S --rates R [R ...]

The highest rate whose p95 stays within a few batches' time and whose
queue does not grow is the knee; a cell's file offers 0.8 of it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

from benchmark import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=7_000_000_000)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    for i, rate in enumerate(args.rates):
        c = copy.deepcopy(cell)
        c.workload["load"]["rate_per_s"] = rate
        c.workload["check"]["batches"] = 1
        runs = {}
        res = run.run_cell(c, args.seed + i, args.seconds, False, t_start=time.perf_counter(),
                           keep=runs)
        reqs = sorted(runs["run"].requests, key=lambda q: q["start"])
        lat = [(q["done"] - q["start"]) * 1e3 for q in reqs if q["ok"]]
        h = len(lat) // 2
        grow = float(np.median(lat[h:]) / np.median(lat[:h])) if h else float("nan")
        stats = runs["run"].counters.get("batcher", {})
        bm = ((stats["after"]["requests"] - stats["before"]["requests"])
              / max(1, stats["after"]["batches"] - stats["before"]["batches"])) if stats else None
        print(json.dumps({"rate_per_s": rate, "correct": res["correct"],
                          "failed": res["failed"], "attempted": res["attempted"],
                          **{k: v["value"] for k, v in res["metrics"].items()},
                          "later_over_earlier_median": grow, "batch_mean": bm}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
