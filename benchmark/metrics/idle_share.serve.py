"""idle_share.serve: one less the union of device activity over the traced
window's first-to-last span, in %."""

from harness import readers


def read(run):
    if run["kind"] != "serve":
        return None
    return readers.idle_share(run)
