"""inference.host_ms.p50: inference.host_ms (`inference.host_ms.py`) in the cells whose tail
is not an end-to-end metric, where it moves latency_p50_ms."""

from pathlib import Path

from benchmark import spec

read = spec.reader(Path(__file__).resolve().parents[1], "inference.host_ms")
