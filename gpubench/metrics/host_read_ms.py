"""Host milliseconds a statement spends in the program's sanctioned
device-to-host reads: the summed ``dur_ms`` of its ``host.read`` spans
(``analysis/runtime.py`` ``host_read``; each waits for the card to drain),
averaged over every kept trace of the window.  A program whose executor
records no ``op.*`` span records no read span either, and gives nothing."""


def instrumented(run) -> bool:
    """Whether the traces come from an executor with operator spans."""
    return any(sp["name"].startswith("op.") for rec in run.traces for sp in rec["spans"])


def read(run):
    if not run.traces or not instrumented(run):
        return None
    per = [sum(sp["dur_ms"] for sp in rec["spans"] if sp["name"] == "host.read")
           for rec in run.traces]
    return sum(per) / len(per)
