"""latency_p95_ms.serve: the 95th percentile of every request completed in
the window, ``submit`` to its Future's result, on the host clock: the same
number as ``serve_p95_ms``, kept with no bound in cells whose closed loop
saturates the card, where the tail swings with the host from run to run."""


def read(run):
    if run["kind"] != "serve" or run.get("p95_ms") is None:
        return None
    return float(run["p95_ms"])
