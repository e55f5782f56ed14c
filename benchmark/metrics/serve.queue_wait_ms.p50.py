"""serve.queue_wait_ms.p50: serve.queue_wait_ms (`serve.queue_wait_ms.py`) in the cells whose tail
is not an end-to-end metric, where it moves latency_p50_ms."""

from pathlib import Path

from benchmark import spec

read = spec.reader(Path(__file__).resolve().parents[1], "serve.queue_wait_ms")
