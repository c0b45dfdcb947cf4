"""One run of one cell: set-up (build, generate, load, warm), the window,
the reading of the program's spans, counters and device trace, the
comparison with the plain reference, and the result line."""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .device import Slice, card
from .loop import JOIN_S, ClosedLoop
from .program import Program
from .spec import Cell, module
from .traffic import client_streams

FORBIDDEN = ("jax", "jaxlib", "flax", "baikaldb_tpu")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a metric reader reads (``gpubench/metrics/<name>.py``:
    ``read(run) -> float | None``; None where it finds nothing to read)."""
    cell: Cell
    records: list                   # the window's statements (loop.Record), by send time
    window_s: float
    answered: int                   # statements that came back inside the window
    setup_s: float
    mem_peak_window: int            # bytes allocated at the window's peak
    tables: dict                    # table -> rows
    counters: dict = field(default_factory=dict)    # the program's, over the window
    traces: list = field(default_factory=list)      # the program's kept traces
    slice: Slice | None = None      # the profiled slice of a traced window

    def in_slice(self) -> list:
        """The statements that came back inside the profiled slice."""
        s = self.slice
        return [r for r in self.records if s is not None and s.p0 <= r.done < s.p1
                and not r.error]


def rows_of(arrow) -> list:
    if arrow is None:
        return []
    cols = [arrow.column(i).to_pylist() for i in range(arrow.num_columns)]
    return list(zip(*cols)) if cols else []


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sleep_until(t: float) -> None:
    while (d := t - time.perf_counter()) > 0:
        time.sleep(min(d, 0.5))


def judge(cell: Cell, records: list, tables: dict, seed: int, device: str,
          answers=None) -> dict:
    """Compare the window's answers (a sample drawn from the seed, or every
    one) with the plain reference -> {number: value}.  ``answers(ref, stmt)``
    stands in for the program's rows (the control and the fault tests)."""
    cfg = cell.config
    refmod = module("refs", cfg["reference"])
    ref = refmod.Reference(cfg, tables, device)
    done = [r for r in records if not r.error]
    n = int(cell.traffic.get("check", {}).get("sample", 0))
    if n and len(done) > n:
        pick = np.random.default_rng([int(seed), 0]).choice(len(done), n, replace=False)
        done = [done[i] for i in sorted(pick)]
    # the reference's answers first, many at a time (numpy and torch let go
    # of the interpreter lock); one statement text is answered once
    distinct = list({r.stmt: None for r in done})
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        want = dict(zip(distinct, ex.map(ref.answer, distinct)))
    numbers = {k: 0 for k in refmod.NUMBERS}
    for r in done:
        got = answers(ref, r.stmt) if answers else rows_of(r.arrow)
        for k, v in ref.compare(r.stmt, got, want[r.stmt]).items():
            numbers[k] = numbers[k] + v if refmod.NUMBERS[k] == "sum" else max(numbers[k], v)
    numbers["checked"] = len(done)
    return numbers


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> tuple[dict | None, int]:
    """-> (the result line, or None where none may be printed; the exit
    code).  ``device="cpu"`` is for the tests alone: the command insists on
    a card."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    cuda = device == "cuda"
    builder = Program.build_kernels(device)
    t = time.perf_counter()
    tables = module("gen", cfg["generator"]).tables(cfg, int(seed))
    log(f"tables generated in {time.perf_counter() - t:.2f} s: "
        + ", ".join(f"{k} {v.num_rows}" for k, v in tables.items()))
    if builder is not None:
        builder.join()
        if builder.err:
            raise builder.err[0]
    t = time.perf_counter()
    prog = Program(device, cfg, trace)
    prog.load(cfg, tables)
    log(f"loaded and staged in {time.perf_counter() - t:.2f} s")
    streams = client_streams(cfg, traffic, int(seed))
    loop = ClosedLoop([prog.session() for _ in streams], streams)
    if trace and cuda:
        Slice.warm()
    t = time.perf_counter()
    warm = traffic.get("warmup", {})
    loop.first_runs()
    loop.passes(int(warm.get("passes", 0)))
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
    if warm.get("seconds"):
        loop.start()
        _sleep_until(time.perf_counter() + float(warm["seconds"]))
        if loop.fatal:
            raise RuntimeError(loop.fatal[0])
        prog.window_begin()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = loop.t0 = time.perf_counter()
    else:
        prog.window_begin()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop.start(t0)
    log(f"warmed in {t0 - t:.2f} s; the window opens {t0 - t_start:.2f} s after the start")
    t_end = t0 + float(seconds)
    sl = None
    if trace and cuda:
        prof = traffic.get("profile", {})
        a = t0 + min(float(prof.get("offset_s", 0.0)), seconds / 4)
        _sleep_until(a)
        sl = Slice()
        sl.start()
        _sleep_until(min(a + float(prof.get("seconds", seconds)), t_end))
        sl.stop()
    _sleep_until(t_end)
    came_back = loop.stop(t_end)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters, traces = prog.window_end()
    records = loop.window()
    run = Run(cell=cell, records=records, window_s=float(seconds),
              answered=loop.answered(t0, t_end), setup_s=t0 - t_start,
              mem_peak_window=window_peak, tables={k: v.num_rows for k, v in tables.items()},
              counters=counters, traces=traces, slice=sl)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = sum(1 for r in records if r.error)
    for r in records:
        if r.error:
            log(f"failed: {r.stmt.sql[:200]}: {r.error}")
            break
    if cuda:
        c = card()
        log(f"card: {c['nvidia_smi']}")
    out = {"correct": False, "attempted": len(records), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device,
                      "kind": c["kind"] if cuda else device,
                      "count": cell.chips if cuda else 0,
                      "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if sl is not None:
        busy = sl.busy_s()
        out["device"].update(busy_s=busy, window_s=sl.seconds)
        spans = [(sp["name"], int(sp["ts_us"] * 1e3),
                  int(sp["ts_us"] * 1e3 + sp["dur_ms"] * 1e6))
                 for rec in traces for sp in rec["spans"]]
        out["breakdown"] = {"device_ops": sl.top_ops(), "idle_gaps": sl.idle_gaps(spans)}
        log(f"profiled slice {sl.seconds:.3f} s: {len(sl.ops)} device operations, busy "
            f"{busy:.4f} s, {len(run.in_slice())} statements came back in it")
    # the program's state goes before the reference runs on the device
    loop.sessions = None
    del loop
    prog.close()
    t = time.perf_counter()
    numbers = judge(cell, records, tables, seed, device)
    log(f"{numbers.pop('checked')} answers compared with the reference in "
        f"{time.perf_counter() - t:.2f} s")
    limits = cfg["limits"]
    ok = all(numbers[k] <= limits[k] for k in limits)
    out["correct"] = bool(ok and came_back and records and not failed)
    if not came_back:
        log(f"a statement did not come back within {JOIN_S:.0f} s of the window's close")
    # the numbers compared, each beside its limit: last on stderr and last
    # in the result line
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    bad_mods = forbidden_modules()
    if bad_mods:
        log("modules of JAX or of the JAX package were loaded: " + ", ".join(bad_mods))
        return None, 3
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return out, 0
