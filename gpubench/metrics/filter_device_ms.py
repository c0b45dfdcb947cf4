"""Device-busy milliseconds a statement inside the device intervals of the
program's ``op.scan``, ``op.filter`` and ``op.project`` spans, where the
pushed and plain predicates and the key and value expressions run: their
intervals' union intersected with the slice's busy intervals, over the
statements that came back inside the slice, as ``agg_device_ms`` reads
``op.agg``.  A program whose spans carry no device interval gives nothing."""

from gpubench.core.device import clip, union_ns
from gpubench.metrics.agg_device_ms import overlap_ns

NAMES = ("op.scan", "op.filter", "op.project")


def read(run):
    if run.slice is None:
        return None
    ivs = [(int(a["dev_ts_us"] * 1e3), int((a["dev_ts_us"] + a["dev_ms"] * 1e3) * 1e3))
           for rec in run.traces for sp in rec["spans"]
           if sp["name"] in NAMES and "dev_ts_us" in (a := sp["attrs"])]
    n = len(run.in_slice())
    if not ivs or not n:
        return None
    ops = clip(union_ns(ivs), run.slice.t0_ns, run.slice.t1_ns)
    return overlap_ns(ops, run.slice.busy()) / 1e6 / n
