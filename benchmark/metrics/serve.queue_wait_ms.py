"""serve.queue_wait_ms (ms): the nearest-rank 95th percentile over the
requests of the untraced part of the window (`benchmark/spans.py`) of
their `serve.queue` spans: from the put into the batcher's queue to the
start of the batch that took the request, the batcher's window included."""

from benchmark import spans, yardstick


def read(run):
    got = spans.untraced(run)
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in spans.named(got or [], "serve.queue")]
    return yardstick.percentile(waits, 95) if waits else None
