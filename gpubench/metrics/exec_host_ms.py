"""Host milliseconds a statement spends in the executor on its own: the
``dur_ms`` of its ``exec.run`` span less the ``host.read`` spans under it
(launching operators, host-side expression work, the walk of the plan),
averaged over the kept traces that hold an ``exec.run``.  A program whose
executor records no ``op.*`` span gives nothing: its reads are not spans."""

from gpubench.metrics.host_read_ms import instrumented


def exec_host(spans: list):
    """``exec.run``'s ms less its ``host.read`` descendants, or None."""
    parent = {sp["span_id"]: sp["parent_id"] for sp in spans}
    runs = {sp["span_id"]: sp["dur_ms"] for sp in spans if sp["name"] == "exec.run"}
    if not runs:
        return None
    for sp in spans:
        if sp["name"] != "host.read":
            continue
        p = sp["parent_id"]
        while p and p not in runs:
            p = parent.get(p)
        if p:
            runs[p] -= sp["dur_ms"]
    return sum(runs.values())


def read(run):
    if not instrumented(run):
        return None
    per = [v for rec in run.traces if (v := exec_host(rec["spans"])) is not None]
    return sum(per) / len(per) if per else None
