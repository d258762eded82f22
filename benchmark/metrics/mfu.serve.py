"""mfu.serve: the reference's FLOPs of the images served in the window over
its seconds, as a share of the configuration's compute type's dense
peak (989 TFLOP/s bfloat16); it bounds every kernel's gain."""

from harness import readers


def read(run):
    if run["kind"] != "serve":
        return None
    return readers.mfu(run, "stylize_per_image")
