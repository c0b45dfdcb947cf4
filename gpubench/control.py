"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision step below the configuration's
(``Reference.answer(stmt, control=True)``), judged as a run's answers are.
It has to come out as not correct; its smallest reading of each number is
that number's upper reading (``PERF.md``).

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

It answers the statements a run of the cell judges (as many as a run
compares: a run's sample, drawn from each client's first statements, or
every distinct statement of a sequence) at the cell's own sizes, on the
card where there is one.  One JSON line a seed."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_readings(cell, seed: int, device: str) -> dict:
    from gpubench.core.cell import judge
    from gpubench.core.loop import Record
    from gpubench.core.spec import module
    from gpubench.core.traffic import client_streams

    cfg = cell.config
    tables = module("gen", cfg["generator"]).tables(cfg, seed)
    streams = client_streams(cfg, cell.traffic, seed)
    n = int(cell.traffic.get("check", {}).get("sample", 0)) or sum(map(len, streams))
    stmts, k = [], 0
    while len(stmts) < n and any(k < len(s) for s in streams):
        stmts += [s[k] for s in streams if k < len(s)]
        k += 1
    records = [Record(0, st, 0.0, 0.0) for st in stmts[:n]]
    numbers = judge(cell, records, tables, seed, device,
                    answers=lambda ref, st: ref.answer(st, control=True))
    limits = cfg["limits"]
    return {"seed": seed, "checked": numbers.pop("checked"), "numbers": numbers,
            "limits": limits, "fails": any(numbers[k] > limits[k] for k in limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    a = ap.parse_args(argv)
    import torch

    from gpubench.core.spec import load_cell

    cell = load_cell(a.workload, ROOT)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        out = control_readings(cell, seed, device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
