"""serve.batch_mean (requests/batch): requests over batches the server's
Batcher formed in the window, from the change in `Batcher.stats`."""


def read(run):
    c = run.counters.get("batcher")
    if not c or "after" not in c:
        return None
    batches = c["after"]["batches"] - c["before"]["batches"]
    if batches <= 0:
        return None
    return (c["after"]["requests"] - c["before"]["requests"]) / batches
