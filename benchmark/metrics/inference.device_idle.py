"""inference.device_idle (%): the share of the traced calls into the
Synthesizer (their "bench.call" spans) in which the card ran no kernel,
copy or memset: idle time while a request is in hand."""

from benchmark import yardstick


def read(run):
    if not run.trace:
        return None
    spans = [e for e in run.trace
             if e.get("name") == "bench.call" and e.get("cat") == "user_annotation"]
    total = sum(e["dur"] for e in spans)
    if not spans or total <= 0:
        return None
    merged = yardstick.intervals(run.trace)
    if not merged:
        return None
    busy = sum(yardstick.busy_within(merged, e["ts"], e["ts"] + e["dur"]) for e in spans)
    return 100.0 * (1.0 - busy / total)
