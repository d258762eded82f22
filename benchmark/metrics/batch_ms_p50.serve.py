"""batch_ms_p50.serve: the batcher's own median of its last 1024 batches,
dispatch to host copy done, on the host clock (``DynamicBatcher.stats()``
``p50_batch_ms``)."""


def read(run):
    b = run.get("batcher")
    if run["kind"] != "serve" or not b or b["p50_batch_ms"] is None:
        return None
    return float(b["p50_batch_ms"])
