"""Share of the profiled slice in which nothing ran on the card: 100 x (1 -
device-busy union / slice length)."""


def read(run):
    if run.slice is None or run.slice.seconds <= 0:
        return None
    busy = run.slice.busy_s()
    return 100.0 * (1.0 - busy / run.slice.seconds) if busy > 0 else None
