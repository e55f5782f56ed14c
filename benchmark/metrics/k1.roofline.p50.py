"""k1.roofline.p50: k1.roofline (`k1.roofline.py`) in the cells whose tail is not an
end-to-end metric, where it moves latency_p50_ms."""

from pathlib import Path

from benchmark import spec

read = spec.reader(Path(__file__).resolve().parents[1], "k1.roofline")
