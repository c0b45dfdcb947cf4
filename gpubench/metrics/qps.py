"""Statements answered per second: all that came back inside the window
(sent inside it or before it), over the window's length (host clock)."""


def read(run):
    return run.answered / run.window_s if run.answered else None
