"""BENCHMARK.json keeps to the benchmark's contract, every name it gives has
its file, and a cell, a configuration or a metric is added by adding files
and entries alone."""

import json
import os
import re
import shutil

import pytest

from gpubench.core import spec
from gpubench.core.traffic import client_streams
from gpubench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_shape(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and 1 <= len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and TEXT.match(c["source"])
        assert c["file"].startswith("gpubench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    names = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        assert set(w) == KEYS["cell"] and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and UNIT.match(m["unit"])
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    every = [m["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for m in bench[k]]
    assert all(NAME.match(n) for n in every)
    for k in ("configs", "workloads"):
        assert len({m["name"] for m in bench[k]}) == len(bench[k])
    metrics = [m["name"] for k in ("end_to_end", "per_layer") for m in bench[k]]
    assert len(set(metrics)) == len(metrics)


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in bench["end_to_end"]}
    for c in cells:
        mine = [n for n, ws in e2e.items() if c in ws]
        assert "setup_s" in mine and len(mine) >= 2, c
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"]), c
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]]), m["name"]


def test_every_name_has_its_file(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        spec.module("gen", cell.config["generator"])
        spec.module("refs", cell.config["reference"])
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.module("metrics", m["name"]).read)
        for name in cell.config["statements"]:
            assert NAME.match(name)


def test_a_cell_is_added_by_files_alone(tmp_path, bench):
    """A new traffic mix of an existing configuration: one traffic file and
    one BENCHMARK.json entry, nothing else edited."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "tpch_sf1-throughput2", "config": "tpch_sf1", "traffic": "throughput2",
         "chips": 1, "why": "two streams of the throughput test"}]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    streams = [["q21", "q3", "q18", "q5"], ["q6", "q17", "q14", "q16"]]
    with open(tmp_path / "gpubench" / "traffic" / "tpch_sf1-throughput2.json", "w") as f:
        json.dump({"clients": 2, "order": "sequence", "sequences": streams,
                   "warmup": {"passes": 1}}, f)
    cell = spec.load_cell("tpch_sf1-throughput2", str(tmp_path))
    assert cell.traffic["clients"] == 2 and cell.config["name"] == "tpch_sf1"
    got = client_streams(cell.config, cell.traffic, 5)
    assert [[s.name for s in c] for c in got] == streams
