"""Share of the HBM roofline that the GROUP BYs take: for each statement
that came back inside the profiled slice, the bytes of the columns its
group keys and aggregates are computed from (the configuration's
``agg_columns``), read once over its table's rows at the widths
``scan_roofline`` gives them, over 3.35 TB/s; summed, over the device-busy
seconds of the slice inside the program's ``op.agg`` device intervals, in
percent.  The same work whatever implements the GROUP BY.  A configuration
without ``agg_columns``, or a program whose spans carry no device
interval, gives nothing."""

from gpubench.metrics.agg_device_ms import op_device_ms
from gpubench.metrics.scan_roofline import HBM_BYTES_PER_S, column_widths


def read(run):
    cfg = run.cell.config
    if run.slice is None or "agg_columns" not in cfg:
        return None
    ms = op_device_ms(run, "op.agg")
    if not ms:
        return None
    busy_s = ms * len(run.in_slice()) / 1e3
    widths = column_widths(cfg["tables"])
    nbytes = sum(widths[c] * run.tables[c.split(".")[0]]
                 for r in run.in_slice() for c in cfg["agg_columns"].get(r.stmt.name, []))
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy_s if nbytes else None
