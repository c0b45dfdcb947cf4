"""The comparison catches a broken timed path: each test drives a whole run
of a cell on the CPU at a small size (the command's look for a card
skipped), with the program broken underneath, and sees ``correct`` come
out false.  The faults a query engine can have: an answer altered where it
is produced, half of the rows left out of the aggregation, and a statement
answered with its session's previous (unchanged) answer.  The control,
the reference computed one precision step below the configuration's in
the program's place, fails as well."""

import dataclasses
import itertools

import pyarrow as pa
import pytest

from gpubench.control import control_readings
from gpubench.core.cell import run_cell
from gpubench.core.spec import load_cell
from gpubench.tests.conftest import ROOT

SMALL = {"tpch_sf1-power": {"scale": 0.05}}


def small(name):
    cell = load_cell(name, ROOT)
    return dataclasses.replace(cell, config={**cell.config, **SMALL[name]})


def _altered(res):
    """The result with its first row's last value moved."""
    t = res.arrow
    if t is None or t.num_rows == 0:
        return res
    i = t.num_columns - 1
    vals = t.column(i).to_pylist()
    v = vals[0]
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return res
    vals[0] = v + 1 if isinstance(v, int) else v * (1 + 1e-3) + 1e-3
    return dataclasses.replace(res, arrow=t.set_column(i, t.column_names[i],
                                                       pa.array(vals, t.column(i).type)))


@pytest.fixture
def fault(monkeypatch):
    from baikaldb_tpu_torch.exec import session
    from baikaldb_tpu_torch.ops import group_kernels, segments

    real = session.Session.execute

    def plant(kind):
        if kind == "altered":
            n = itertools.count()

            def execute(self, sql):
                res = real(self, sql)
                return _altered(res) if next(n) % 5 == 0 else res
            monkeypatch.setattr(session.Session, "execute", execute)
        elif kind == "half_rows":
            for mod in (group_kernels, segments):
                inner = mod._routed

                def routed(*a, _inner=inner):
                    gid = _inner(*a)
                    drop = int(a[-1])
                    gid = gid.clone()
                    gid[1::2] = drop
                    return gid
                monkeypatch.setattr(mod, "_routed", routed)
        elif kind == "stale":
            def execute(self, sql):
                res = real(self, sql)
                prev = getattr(self, "_gpubench_prev", None)
                self._gpubench_prev = res
                return prev if prev is not None and prev.arrow is not None else res
            monkeypatch.setattr(session.Session, "execute", execute)
    return plant


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("kind", ["altered", "half_rows", "stale"])
def test_a_broken_path_is_not_correct(fault, cell, kind):
    fault(kind)
    out, rc = run_cell(small(cell), 2**31 + 99, 2.0, False, "cpu")
    assert rc == 0 and out["attempted"] > 0
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    out, rc = run_cell(small(cell), 2**31 + 7, 2.0, True, "cpu")
    assert rc == 0 and out["correct"] is True and out["failed"] == 0, out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_the_control_is_not_correct(cell, seed):
    assert control_readings(small(cell), seed, "cpu")["fails"]
