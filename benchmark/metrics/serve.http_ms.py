"""serve.http_ms (ms): the median over the answered requests (`status`
200) of the untraced part of the window (`benchmark/spans.py`) of the HTTP
thread's own time on a request: its `serve.request` span from its start to
the end of its `serve.parse` (reading the body, decoding the JSON), and
from the start of its `serve.encode` (the WAV) to its end (the response
written). The wait for the batch between them is `serve.queue` and the
batch's own spans."""

import statistics

from benchmark import spans


def read(run):
    got = spans.untraced(run)
    if not got:
        return None
    reqs = [r for r in spans.named(got, "serve.request") if r.attrs.get("status") == 200]
    parse = spans.children(got, reqs, "serve.parse")
    encode = spans.children(got, reqs, "serve.encode")
    own = [(parse[r.id][0].end_ns - r.start_ns + r.end_ns - encode[r.id][0].start_ns) / 1e6
           for r in reqs if parse[r.id] and encode[r.id]]
    return statistics.median(own) if own else None
