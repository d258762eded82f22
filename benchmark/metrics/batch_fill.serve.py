"""batch_fill.serve: the requests the batcher served in the window over
its batches times the batch size, in % (``DynamicBatcher.stats()``)."""


def read(run):
    b = run.get("batcher")
    if run["kind"] != "serve" or not b or not b["batches"]:
        return None
    return 100.0 * b["served"] / (b["batches"] * run["batch"])
