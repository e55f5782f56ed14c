"""inference.host_ms (ms): the median over the Synthesizer's calls in the
untraced part of the window (`benchmark/spans.py`) of an `inference.call`
span's wall less its `inference.wait` spans (the two device-to-host
copies, each waiting for the card first): graph launches, input copies
(each a sync of its own), the host rounding and the rest of the host's
work in a call."""

import statistics

from benchmark import spans


def read(run):
    got = spans.untraced(run)
    if not got:
        return None
    calls = spans.named(got, "inference.call")
    waits = spans.children(got, calls, "inference.wait")
    host = [(c.end_ns - c.start_ns - sum(w.end_ns - w.start_ns for w in waits[c.id])) / 1e6
            for c in calls]
    return statistics.median(host) if host else None
