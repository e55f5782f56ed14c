"""k1.roofline (%): the least time the card's HBM needs to move the bytes K1
(the forward AdaIN+snake kernel, `csrc/adain_snake.cu`) needs for the
traced calls' answers at their own frames (`yardstick.k1_bytes`: each
input byte read once, each output byte written once) over K1's summed
kernel time in the traced slice (kernels by name)."""

from benchmark import yardstick


def read(run):
    if not run.trace:
        return None
    spans = [e for e in run.trace
             if e.get("name") == "bench.call" and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    lo, hi = min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)
    k1_us = sum(e["dur"] for e in run.trace if e.get("cat") == "kernel"
                and yardstick.K1_KERNEL in e.get("name", "") and lo <= e["ts"] <= hi)
    traced = [c for c in run.calls if c.get("traced")]
    if k1_us <= 0 or not traced:
        return None
    need = sum(yardstick.k1_bytes(run.cfg, f) for c in traced for f in c["frames"])
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / (k1_us / 1e6)
