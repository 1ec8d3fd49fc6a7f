"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
