"""Peak device memory allocated during the window (the resident tables and
the working set), ``torch.cuda.max_memory_allocated`` after a reset at the
window's start, in GiB."""


def read(run):
    return run.mem_peak_window / 2**30 if run.mem_peak_window else None
