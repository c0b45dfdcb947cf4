"""Share of the HBM roofline that the statements' column reads take: for
each statement that came back inside the profiled slice, the bytes of
every column it references (the configuration's ``scan_columns``), read
once over its table's rows at the widths the benchmark generates them (4
for INT, DATE, FLOAT and dictionary codes, 8 for BIGINT and DOUBLE), over
3.35 TB/s; summed, over the slice's device-busy seconds, in percent.  The
same work whatever kernels run a query."""

import re

HBM_BYTES_PER_S = 3.35e12        # NVIDIA H100 SXM data sheet
WIDTH = {"INT": 4, "DATE": 4, "FLOAT": 4, "VARCHAR": 4, "CHAR": 4, "BIGINT": 8,
         "DOUBLE": 8}


def column_widths(tables: dict) -> dict:
    """"table.column" -> bytes a row, from the configuration's CREATE TABLEs."""
    out = {}
    for name, ddl in tables.items():
        body = ddl[ddl.index("(") + 1:ddl.rindex(")")]
        for col, typ in re.findall(r"(?:^|,)\s*([a-z_][a-z0-9_]*)\s+([A-Z]+)", body):
            out[f"{name}.{col}"] = WIDTH[typ]
    return out


def statement_bytes(config: dict, name: str, rows: dict) -> int:
    widths = column_widths(config["tables"])
    return sum(widths[c] * rows[c.split(".")[0]] for c in config["scan_columns"][name])


def read(run):
    cfg = run.cell.config
    if run.slice is None or "scan_columns" not in cfg:
        return None
    done = [r for r in run.in_slice() if r.stmt.name in cfg["scan_columns"]]
    busy = run.slice.busy_s()
    if not done or busy <= 0:
        return None
    nbytes = sum(statement_bytes(cfg, r.stmt.name, run.tables) for r in done)
    return 100.0 * nbytes / HBM_BYTES_PER_S / busy
