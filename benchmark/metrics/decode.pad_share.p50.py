"""decode.pad_share.p50: decode.pad_share (`decode.pad_share.py`) in the cells whose tail
is not an end-to-end metric, where it moves latency_p50_ms."""

from pathlib import Path

from benchmark import spec

read = spec.reader(Path(__file__).resolve().parents[1], "decode.pad_share")
