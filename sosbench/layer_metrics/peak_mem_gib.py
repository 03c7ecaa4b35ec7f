"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the traced
window, after ``reset_peak_memory_stats`` at its start, in the cells of
library calls (``columns_per_s``)."""
UNIT = "GiB"


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
