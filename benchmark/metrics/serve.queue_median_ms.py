"""serve.queue_median_ms (ms): the median of the waits whose 95th
percentile `serve.queue_wait_ms.py` reads: a request's `serve.queue` span,
from the put into the batcher's queue to the start of the batch that took
it. Where most requests reach an idle worker, this is the batcher's window
that a lone request waits out; the 95th percentile reads the requests that
arrived while a batch ran."""

import statistics

from benchmark import spans


def read(run):
    got = spans.untraced(run)
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in spans.named(got or [], "serve.queue")]
    return statistics.median(waits) if waits else None
