"""idle_share.train: one less the union of device activity over the traced
window's first-to-last span, in %."""

from harness import readers


def read(run):
    if run["kind"] != "train":
        return None
    return readers.idle_share(run)
