"""Device-busy milliseconds a statement: the union of the intervals in which
a kernel, copy or set ran on the card in the profiled slice (``torch.profiler``),
over the statements that came back inside the slice."""


def read(run):
    if run.slice is None:
        return None
    n = len(run.in_slice())
    busy = run.slice.busy_s()
    return busy * 1e3 / n if n and busy > 0 else None
