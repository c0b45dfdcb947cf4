"""What the benchmark imports: no module under gpubench/ imports JAX or the
JAX package (top-level names compared whole: ``baikaldb_tpu_torch`` begins
with ``baikaldb_tpu``), and the references and generators import nothing
of the program.  Without a CUDA card, or without the program beside it, a
run exits non-zero and prints no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from gpubench.tests.conftest import ROOT

PKG = os.path.join(ROOT, "gpubench")
FORBIDDEN = {"jax", "jaxlib", "flax", "baikaldb_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            yield n.module
        elif isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "import_module" \
                and n.args and isinstance(n.args[0], ast.Constant):
            yield n.args[0].value


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_anywhere(path):
    bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(list(_sources("refs")) + list(_sources("gen"))),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_references_and_generators_import_nothing_of_the_program(path):
    assert not {m for m in _imports(path) if m.split(".")[0] == "baikaldb_tpu_torch"}


def test_only_the_program_module_imports_the_program():
    users = {os.path.relpath(p, PKG) for p in _sources()
             if any(m.split(".")[0] == "baikaldb_tpu_torch" for m in _imports(p))}
    assert users <= {"core/program.py"} | {os.path.relpath(p, PKG)
                                            for p in _sources("tests")}, users


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                           "tpch_sf1-power", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_loaded_jax_is_found(monkeypatch):
    from gpubench.core.cell import forbidden_modules

    assert forbidden_modules() == [] or all(m.split(".")[0] in FORBIDDEN
                                             for m in forbidden_modules())
    monkeypatch.setitem(sys.modules, "baikaldb_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "baikaldb_tpu_torchlike", object())
    assert "baikaldb_tpu.ops" in forbidden_modules()
    assert "baikaldb_tpu_torchlike" not in forbidden_modules()
