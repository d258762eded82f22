"""mfu.train: the reference's FLOPs of the images trained in the window over
its seconds, as a share of the configuration's compute type's dense
peak (989 TFLOP/s bfloat16); it bounds every kernel's gain."""

from harness import readers


def read(run):
    if run["kind"] != "train":
        return None
    return readers.mfu(run, "train_step_per_image")
