"""A cell's files, found by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic; the configuration is
``gpubench/configs/<config>.json``, the traffic ``gpubench/traffic/<cell>.json``,
each per-layer metric ``gpubench/metrics/<metric>.py``, the generator
``gpubench/gen/<generator>.py`` and the reference ``gpubench/refs/<reference>.py``."""

from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, "gpubench", "traffic", f"{_named(name)}.json"))

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def module(kind: str, name: str):
    """``gpubench.<kind>.<name>``: a generator, a reference or a metric."""
    mod = _named(name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"gpubench.{kind}.{mod}")
