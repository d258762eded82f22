"""folded_conv_roofline.train: the least time of the traced window's
``rpst_torch.ops.folded_conv`` launches by their shapes' bounds over the
device time of their kernels, in %."""

from harness import readers


def read(run):
    if run["kind"] != "train":
        return None
    return readers.roofline(run, "folded_conv", "train")
