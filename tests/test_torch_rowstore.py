"""The port's row tier (storage/rowstore.py over its own native/engine.cpp)
against the JAX package's: memcomparable key bytes, the value codec, the MVCC
memtable, WAL recovery, transactions and conflicts.  Keys, values and WAL
files are compared byte for byte; the port's native codec is also held
against its pure-Python codec (storage/_pykeys.py)."""

import datetime

import numpy as np
import pytest

from baikaldb_tpu.storage import rowstore as jrs
from baikaldb_tpu.types import Field as JField, LType as JLType, Schema as JSchema
from baikaldb_tpu_torch import native
from baikaldb_tpu_torch.storage import _pykeys, rowstore as trs
from baikaldb_tpu_torch.types import Field, LType, Schema

SCHEMA = Schema((Field("id", LType.INT64, nullable=False), Field("name", LType.STRING),
                 Field("score", LType.FLOAT64), Field("d", LType.DATE)))
JSCHEMA = JSchema((JField("id", JLType.INT64, nullable=False), JField("name", JLType.STRING),
                   JField("score", JLType.FLOAT64), JField("d", JLType.DATE)))


@pytest.fixture(params=["native", "python"])
def engine(request, monkeypatch):
    """The port's row tier on its native engine and on the Python codec."""
    monkeypatch.setattr(trs, "FORCE_PYTHON", request.param == "python")
    assert trs.engine_name() == request.param
    return request.param


def _keys(rng, n):
    ids = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
    ids[:4] = [-1, 0, 1, -(2 ** 63)]
    scores = rng.standard_normal(n) * 1e6
    scores[:3] = [-0.0, 0.0, 1e-300]
    names = np.asarray(["".join(rng.choice(list("ab\x00\x01z"), rng.integers(0, 5)))
                        for _ in range(n)], dtype=object)
    valid = rng.random(n) > 0.2
    return ids, names, scores, valid


def test_native_engine_builds_into_the_build_dir():
    assert native.available(), native.build_error()
    assert native.require() is native.get_lib()
    assert native._so_path().startswith(native.BUILD_DIR)


def test_key_bytes_match_jax_and_python(engine):
    rng = np.random.default_rng(3)
    ids, names, scores, valid = _keys(rng, 300)
    for cols, kcols, vals in ((["id"], [ids], [None]),
                              (["score"], [scores], [valid]),
                              (["name"], [names], [valid]),
                              (["id", "name", "score"], [ids, names, scores],
                               [None, valid, ~valid])):
        got = trs.KeyCodec(SCHEMA, cols).encode_rows(kcols, vals)
        want = jrs.KeyCodec(JSCHEMA, cols).encode_rows(kcols, vals)
        assert got == want
        kinds = trs.KeyCodec(SCHEMA, cols).kinds
        assert got == _pykeys.encode_rows(kinds, kcols, vals, len(ids))


def test_key_order_preserving(engine):
    kc = trs.KeyCodec(SCHEMA, ["id"])
    vals = [-(2 ** 62), -5, -1, 0, 1, 7, 2 ** 62]
    assert kc.encode_rows([np.asarray(vals, np.int64)], [None]) == \
        sorted(kc.encode_rows([np.asarray(vals, np.int64)], [None]))
    kcf = trs.KeyCodec(SCHEMA, ["score"])
    fkeys = kcf.encode_rows([np.asarray([-1e18, -2.5, -0.0, 0.0, 1e-9, 3.14, 1e18])], [None])
    assert fkeys == sorted(fkeys)
    kcs = trs.KeyCodec(SCHEMA, ["name"])
    skeys = kcs.encode_rows([np.asarray(["", "a", "a\x00b", "a\x01", "ab", "b"], object)],
                            [None])
    assert skeys == sorted(skeys)


def test_row_codec_matches_jax():
    rows = [{"id": 42, "name": "héllo", "score": -1.5, "d": datetime.date(2024, 3, 1)},
            {"id": 1, "name": None, "score": None, "d": None},
            {"id": -7, "name": "", "score": float("inf"), "d": datetime.date(1969, 12, 31)}]
    rc, jrc = trs.RowCodec(SCHEMA), jrs.RowCodec(JSCHEMA)
    for row in rows:
        assert rc.encode(row) == jrc.encode(row)
        assert rc.decode(rc.encode(row)) == row


def test_put_get_scan_mvcc_and_gc(engine):
    t = trs.RowTable(SCHEMA, ["id"])
    t.put_row({"id": 1, "name": "a", "score": 1.0, "d": None})
    s1 = t.snapshot()
    t.put_row({"id": 1, "name": "b", "score": 2.0, "d": None})
    t.put_row({"id": 2, "name": "c", "score": 3.0, "d": None})
    assert t.get_row({"id": 1}, snapshot=s1)["name"] == "a"
    assert t.get_row({"id": 2}, snapshot=s1) is None
    assert [r["id"] for r in t.scan_rows()] == [1, 2]
    t.delete_row({"id": 1})
    assert t.get_row({"id": 1}) is None
    assert t.get_row({"id": 1}, snapshot=s1)["name"] == "a"
    for i in range(5):
        t.put_row({"id": 7, "name": f"v{i}", "score": None, "d": None})
    t.delete_row({"id": 8})
    t.gc(t.snapshot())
    assert t.get_row({"id": 7})["name"] == "v4"
    assert t.num_keys() == 2 and t.num_live_keys() == 2   # tombstone-only keys go


def test_wal_bytes_match_jax_and_recover_across_packages(engine, tmp_path):
    """The same writes leave the same WAL file in both packages, and each
    package recovers the other's."""
    ops = [("put", {"id": 1, "name": "x", "score": 0.5, "d": datetime.date(2020, 1, 2)}),
           ("put", {"id": 2, "name": "y", "score": None, "d": None}),
           ("del", {"id": 1}),
           ("put", {"id": 3, "name": "z\x00", "score": -2.0, "d": None})]
    paths = {}
    for pkg, mod, sch in (("port", trs, SCHEMA), ("jax", jrs, JSCHEMA)):
        paths[pkg] = str(tmp_path / f"{pkg}.wal")
        t = mod.RowTable(sch, ["id"], wal_path=paths[pkg])
        for op, row in ops:
            t.put_row(row) if op == "put" else t.delete_row(row)
        del t
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    want = [{"id": 2, "name": "y", "score": None, "d": None},
            {"id": 3, "name": "z\x00", "score": -2.0, "d": None}]
    assert trs.RowTable(SCHEMA, ["id"], wal_path=paths["jax"]).scan_rows() == want
    assert jrs.RowTable(JSCHEMA, ["id"], wal_path=paths["port"]).scan_rows() == want


def test_txn_commit_rollback_conflict(engine):
    t = trs.RowTable(SCHEMA, ["id"])
    t.put_row({"id": 1, "name": "base", "score": None, "d": None})
    txn = t.begin()
    txn.put_row({"id": 1, "name": "mine", "score": None, "d": None})
    txn.put_rows([{"id": 5, "name": "new", "score": None, "d": None},
                  {"id": 6, "name": "new2", "score": 1.0, "d": None}])
    assert txn.get_row({"id": 1})["name"] == "mine"
    assert t.get_row({"id": 1})["name"] == "base"
    other = t.begin()
    with pytest.raises(trs.ConflictError):
        other.put_row({"id": 6, "name": "theirs", "score": None, "d": None})
    other.rollback()
    before = t.snapshot()
    txn.commit()
    assert t.scan_rows(snapshot=before) == [{"id": 1, "name": "base", "score": None, "d": None}]
    assert [r["name"] for r in t.scan_rows()] == ["mine", "new", "new2"]
    t2 = t.begin()
    t2.put_row({"id": 9, "name": "tmp", "score": None, "d": None})
    t2.rollback()
    assert t.get_row({"id": 9}) is None
    t3 = t.begin()
    t3.put_row({"id": 9, "name": "ok", "score": None, "d": None})
    t3.commit()
    assert t.get_row({"id": 9})["name"] == "ok"


def test_savepoints_restore_overwritten_keys(engine):
    t = trs.RowTable(SCHEMA, ["id"])
    txn = t.begin()
    txn.put_row({"id": 1, "name": "v1", "score": None, "d": None})
    sp = txn.savepoint()
    txn.put_row({"id": 1, "name": "v2", "score": None, "d": None})
    txn.put_row({"id": 2, "name": "b", "score": None, "d": None})
    txn.rollback_to(sp)
    assert txn.get_row({"id": 1})["name"] == "v1"
    txn.commit()
    assert [r["name"] for r in t.scan_rows()] == ["v1"]


def test_composite_and_null_keys(engine):
    t = trs.RowTable(SCHEMA, ["id", "name"])
    t.put_row({"id": 1, "name": "b", "score": 1.0, "d": None})
    t.put_row({"id": 1, "name": None, "score": 2.0, "d": None})
    t.put_row({"id": 1, "name": "a", "score": 3.0, "d": None})
    assert [r["name"] for r in t.scan_rows()] == [None, "a", "b"]
    assert t.get_row({"id": 1, "name": None})["score"] == 2.0
