"""Spreads of a cell's runs, for setting its bounds.

    python3 -m benchmark.spreads SET_A_FILE... -- SET_B_FILE...

Each file holds one run's standard output (its last line the result).
For each metric: each set's median and spread (the quartile distance over
the median, `statistics.quantiles(n=4)`), the wider spread, the spread of
each set without its run farthest from the median, and five times the
wider spread (the bound it suggests, never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def results(paths: List[str]) -> List[dict]:
    out = []
    for p in paths:
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        out.append(json.loads(lines[-1]))
    return out


def spread(values: List[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def trimmed(values: List[float]) -> List[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def table(sets: List[List[dict]]) -> Dict[str, dict]:
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    out = {}
    for n in names:
        vals = [[r["metrics"][n]["value"] for r in s if n in r["metrics"]] for s in sets]
        sp = [spread(v) for v in vals]
        out[n] = {"medians": [statistics.median(v) for v in vals], "spreads": sp,
                  "trimmed_spreads": [spread(trimmed(v)) for v in vals],
                  "wider": max(sp), "bound_5x": max(0.01, 5 * max(sp))}
    return out


def main(argv: List[str]) -> int:
    if "--" in argv:
        i = argv.index("--")
        sets = [results(argv[:i]), results(argv[i + 1:])]
    else:
        sets = [results(argv)]
    for name, row in table(sets).items():
        print(json.dumps({"metric": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
