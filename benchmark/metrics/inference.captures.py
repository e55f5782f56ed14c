"""inference.captures (graphs): CUDA graphs the Synthesizer captured inside
the window, keys that set-up missed: the change in `len(Synthesizer.graphs)`."""


def read(run):
    c = run.counters.get("graphs")
    if not c or "after" not in c:
        return None
    return c["after"] - c["before"]
