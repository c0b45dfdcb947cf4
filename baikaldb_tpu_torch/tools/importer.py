"""Bulk importer (reference: src/tools/importer*.cpp ~4k LoC).

The reference's importer is job-driven: a JSON description names the target
table, source files, and format; jobs trigger when a DONE marker file
appears next to the data (importer.cpp:139-141 done-file polling), and a
"fast importer" bypasses the SQL write path by building SSTs directly.

Mapping (the port of ``baikaldb_tpu/tools/importer.py``; the rows land in
the port's stores, whose device images restage from them):

- ``hot`` mode: rows go through the session ingest path — PK-checked,
  WAL/raft-durable, global indexes maintained (the plain importer).
- ``fast`` mode: rows land straight in the COLD tier — immutable Parquet
  segments on the external FS with the manifest raft-committed (the
  SST-building fast importer: no per-row consensus writes), then the
  column cache refreshes.  Requires a fleet-replicated table and a
  configured cold FS.
- ``watch_dir`` polls for ``<job>.done`` markers and runs the matching
  ``<job>.json`` job exactly once (renamed ``.imported`` after success).

CLI:  python -m baikaldb_tpu_torch.tools.importer --job j.json [--watch DIR]
          [--data-dir D | --meta ADDR] [--cold-dir D] [--device cpu]
(the engine runs on the CUDA card unless ``--device`` names another)
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import pyarrow as pa
import pyarrow.parquet as pq


@dataclass
class ImportJob:
    """One import job (the reference's JSON job description analog)."""
    table: str                       # "db.table" or bare name
    files: list[str] = field(default_factory=list)
    format: str = "csv"              # csv | parquet
    delimiter: str = ","
    mode: str = "hot"                # hot | fast
    columns: list[str] = field(default_factory=list)   # csv header override

    @classmethod
    def from_json(cls, path: str) -> "ImportJob":
        with open(path) as f:
            d = json.load(f)
        job = cls(table=d["table"], files=list(d.get("files", [])),
                  format=d.get("format", "csv"),
                  delimiter=d.get("delimiter", ","),
                  mode=d.get("mode", "hot"),
                  columns=list(d.get("columns", [])))
        base = os.path.dirname(os.path.abspath(path))
        job.files = [f if os.path.isabs(f) else os.path.join(base, f)
                     for f in job.files]
        return job


def _read_file(job: ImportJob, path: str, schema) -> pa.Table:
    from ..storage.column_store import schema_to_arrow

    arrow = schema_to_arrow(schema)
    if job.format == "parquet":
        t = pq.read_table(path)
        return t.select([c for c in arrow.names if c in t.column_names])
    from pyarrow import csv as pacsv

    names = job.columns or list(arrow.names)
    ropt = pacsv.ReadOptions(column_names=names)
    popt = pacsv.ParseOptions(delimiter=job.delimiter)
    copt = pacsv.ConvertOptions(
        column_types={f.name: arrow.field(f.name).type
                      for f in arrow if f.name in names},
        null_values=["", "\\N", "NULL"], strings_can_be_null=True)
    return pacsv.read_csv(path, read_options=ropt, parse_options=popt,
                          convert_options=copt)


def run_job(session, job: ImportJob) -> int:
    """Execute one job; returns rows imported."""
    db, _, name = job.table.rpartition(".")
    db = db or session.current_db
    info = session.db.catalog.get_table(db, name)
    store = session.db.stores.get(f"{db}.{name}")
    if store is None:
        store = session.db.stores[f"{db}.{name}"] = \
            session.db.make_store(info)
    total = 0
    if job.mode == "fast":
        return _run_fast(session, job, info, store)
    for path in job.files:
        t = _read_file(job, path, info.schema)
        session._ingest_arrow(store, t, check_dups=True)
        total += t.num_rows
    session.db.binlog.append(
        "insert", db, name,
        statement=f"IMPORT {len(job.files)} files", affected=total)
    if session.db.data_dir:
        # bulk rows are cold appends (durable at checkpoint, not per-row
        # WAL'd); job completion IS the durability point — exactly the
        # reference's importer contract (files fully ingested or not at all)
        session.db.checkpoint()
    return total


def _run_fast(session, job: ImportJob, info, store) -> int:
    """Fast import: build immutable cold segments directly (the reference's
    SST-building fast_importer, bypassing per-row consensus writes).  The
    rows get cluster-allocated rowids, land on the external FS as ONE
    segment per file, and the manifest entries raft-commit; the column
    cache then refreshes from cold+hot."""
    from ..raft.cluster import CMD_COLD
    from ..storage.coldfs import segment_bytes
    from ..storage.column_store import ROWID, schema_to_arrow
    from ..storage.replicated import ReplicatedRowTier

    tier = store.replicated
    if not isinstance(tier, ReplicatedRowTier):
        raise ValueError("fast import requires a fleet-replicated table")
    fs = session.db.cold_fs(required=True)
    if any(ix.kind in ("global", "global_unique")
           for ix in info.indexes):
        raise ValueError("fast import cannot maintain global indexes; "
                         "use mode=hot")
    row_arrow = schema_to_arrow(store._row_schema())
    total = 0
    with tier._mu:
        g = tier.groups[0]
        m = tier.metas[0]
        for path in job.files:
            t = _read_file(job, path, info.schema)
            if not t.num_rows:
                continue
            start = tier.alloc_rowids(t.num_rows)
            rows = t.to_pylist()
            for i, r in enumerate(rows):
                r[ROWID] = start + i
            seq = tier.alloc_rowids(1)
            seg = f"{tier.table_key}.r{m.region_id}.s{seq}.parquet"
            fs.put(seg, segment_bytes(rows, row_arrow))
            payload = json.dumps({"op": "add", "seq": int(seq),
                                  "file": seg,
                                  "watermark": -1}).encode()
            # watermark -1: a pure-cold segment evicts nothing hot
            if not g.propose_cmd(CMD_COLD, 0, payload):
                raise RuntimeError("fast import: manifest propose failed")
            total += t.num_rows
    # refresh the column cache: rebuild the store, which re-attaches the
    # tier and replays cold (incl. the new segments) + hot
    session.db.stores[f"{info.database}.{info.name}"] = \
        session.db.make_store(info)
    session.db.binlog.append(
        "insert", info.database, info.name,
        statement=f"FAST IMPORT {len(job.files)} files", affected=total)
    return total


def watch_dir(session, directory: str, poll_s: float = 1.0,
              max_rounds: int | None = None) -> int:
    """Done-file watcher: a job runs when BOTH <name>.json and <name>.done
    exist (the data writer drops .done last — the reference's protocol for
    'the files are complete').  Successful jobs rename .done -> .imported.
    Returns jobs executed (runs until max_rounds when given, else forever).
    """
    done = 0
    rounds = 0
    while True:
        for f in sorted(os.listdir(directory)):
            if not f.endswith(".done"):
                continue
            stem = f[:-len(".done")]
            jpath = os.path.join(directory, stem + ".json")
            if not os.path.exists(jpath):
                continue
            job = ImportJob.from_json(jpath)
            run_job(session, job)
            os.replace(os.path.join(directory, f),
                       os.path.join(directory, stem + ".imported"))
            done += 1
        rounds += 1
        if max_rounds is not None and rounds >= max_rounds:
            return done
        time.sleep(poll_s)


def main(argv=None) -> int:
    import argparse

    from ..exec.session import Database, Session

    ap = argparse.ArgumentParser()
    ap.add_argument("--job", help="job JSON path")
    ap.add_argument("--watch", help="directory to poll for .done markers")
    ap.add_argument("--data-dir", default="", help="durable Database dir")
    ap.add_argument("--meta", default="", help="cluster meta address")
    ap.add_argument("--cold-dir", default="", help="cold-tier directory")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card)")
    args = ap.parse_args(argv)
    db = Database(args.device, data_dir=args.data_dir or None,
                  cluster=args.meta or None, cold_dir=args.cold_dir or None)
    s = Session(db)
    if args.job:
        n = run_job(s, ImportJob.from_json(args.job))
        print(json.dumps({"imported": n}))
        return 0
    if args.watch:
        watch_dir(s, args.watch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
