"""Sanctioned device-to-host reads a statement: the program's counter
``host_reads`` (``utils/metrics.py``, one a ``host_read`` of a tensor) over
the window, over the statements answered in it.  A program without the
counter gives nothing."""


def read(run):
    if "host_reads" not in run.counters or not run.answered:
        return None
    return run.counters["host_reads"] / run.answered
