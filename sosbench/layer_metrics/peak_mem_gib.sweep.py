"""peak_mem_gib.sweep: ``torch.cuda.max_memory_allocated`` over the
traced window, after ``reset_peak_memory_stats`` at its start, on the
fullest card, in the sweep cells (``sweep_columns_per_s``)."""
UNIT = "GiB"


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
