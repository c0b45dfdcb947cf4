"""Device-busy milliseconds a statement inside the device intervals of the
program's ``op.agg`` spans: each span's ``[dev_ts_us, dev_ts_us + dev_ms]``
(``obs/trace.py`` puts the interval on the wall clock of the profiled
slice) intersected with the slice's busy intervals, over the statements
that came back inside the slice, as ``device_ms`` counts them.  A program
whose spans carry no device interval gives nothing."""

from gpubench.core.device import clip, union_ns


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def op_device_ms(run, name: str):
    """Busy ms a statement inside the device intervals of the spans ``name``."""
    if run.slice is None:
        return None
    ivs = [(int(a["dev_ts_us"] * 1e3), int((a["dev_ts_us"] + a["dev_ms"] * 1e3) * 1e3))
           for rec in run.traces for sp in rec["spans"]
           if sp["name"] == name and "dev_ts_us" in (a := sp["attrs"])]
    n = len(run.in_slice())
    if not ivs or not n:
        return None
    ops = clip(union_ns(ivs), run.slice.t0_ns, run.slice.t1_ns)
    return overlap_ns(ops, run.slice.busy()) / 1e6 / n


def read(run):
    return op_device_ms(run, "op.agg")
