"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start, in GiB."""


def read(run):
    if run["kind"] != "train" or not run.get("peak_mem_window"):
        return None
    return run["peak_mem_window"] / 2 ** 30
