"""Host milliseconds a statement spends in the session layer: the program's
``parse`` span and its ``plan.*`` spans (paramize, build, bind) directly
under the statement's root, from ``obs/trace.py``, averaged over every
statement of the window the tracer kept (all of them: the traced run keeps
every trace)."""


def read(run):
    per = []
    for rec in run.traces:
        root = next((s["span_id"] for s in rec["spans"] if not s["parent_id"]), None)
        per.append(sum(s["dur_ms"] for s in rec["spans"] if s["parent_id"] == root
                       and (s["name"] == "parse" or s["name"].startswith("plan."))))
    return sum(per) / len(per) if per else None
