"""flash_attention_roofline.serve: the least time of the traced window's
``rpst_torch.ops.flash_attention`` launches by their shapes' bounds over the
device time of their kernels, in %."""

from harness import readers


def read(run):
    if run["kind"] != "serve":
        return None
    return readers.roofline(run, "flash_attention", "serve")
