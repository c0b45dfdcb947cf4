"""Backup / restore tooling (reference: src/store/backup.cpp region SST
export/import + backup_tool/backup_import CLIs).

Single-node analog: every table dumps its regions as Parquet files plus a
catalog manifest (schema, indexes, options, versions); restore rebuilds a
Database from the manifest.  The port of ``baikaldb_tpu/tools/backup.py``:
the layout is the JAX package's, so a backup dumped by either package
restores in the other; ``restore`` builds its Database on ``device`` (None:
the CUDA card).

CLI: python -m baikaldb_tpu_torch.tools.backup restore --dir PATH [--device cpu]
(dump needs an in-process Database: ``dump(db, directory)``).
"""

from __future__ import annotations

import json
import os

from ..exec.session import Database
from ..meta.catalog import IndexInfo
from ..storage.column_store import TableStore
from ..types import Field, LType, Schema


def dump(db: Database, directory: str) -> dict:
    os.makedirs(directory, exist_ok=True)
    manifest: dict = {"databases": {}, "tables": []}
    for dbname in db.catalog.databases():
        if dbname == "information_schema":
            continue
        manifest["databases"][dbname] = db.catalog.tables(dbname)
        for tname in db.catalog.tables(dbname):
            info = db.catalog.get_table(dbname, tname)
            entry = {
                "database": dbname,
                "name": tname,
                "version": info.version,
                "options": info.options,
                "fields": [[f.name, f.ltype.value, f.nullable]
                           for f in info.schema.fields],
                "indexes": [[ix.name, ix.kind, ix.columns]
                            for ix in info.indexes],
            }
            store = db.stores.get(f"{dbname}.{tname}")
            tdir = os.path.join(directory, dbname, tname)
            if store is not None:
                store.save_parquet(tdir)
                entry["data_dir"] = os.path.relpath(tdir, directory)
            manifest["tables"].append(entry)
    with open(os.path.join(directory, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def restore(directory: str, device=None) -> Database:
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        manifest = json.load(f)
    db = Database(device)
    for dbname in manifest["databases"]:
        if dbname != "default":
            db.catalog.create_database(dbname, if_not_exists=True)
    for entry in manifest["tables"]:
        schema = Schema(tuple(Field(n, LType(t), nullable)
                              for n, t, nullable in entry["fields"]))
        indexes = [IndexInfo(n, k, cols) for n, k, cols in entry["indexes"]]
        info = db.catalog.create_table(entry["database"], entry["name"], schema,
                                       indexes, options=entry.get("options", {}))
        info.version = entry["version"]
        store = TableStore(info, db.device)
        store.attach_mvcc(db.mvcc)
        db.stores[f"{entry['database']}.{entry['name']}"] = store
        if "data_dir" in entry:
            store.load_parquet(os.path.join(directory, entry["data_dir"]))
    return db


def main():  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("action", choices=["dump", "restore"])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card)")
    args = ap.parse_args()
    if args.action == "restore":
        db = restore(args.dir, args.device)
        total = sum(s.num_rows for s in db.stores.values())
        print(f"restored {len(db.stores)} tables, {total} rows")
    else:
        raise SystemExit("dump requires an in-process Database; use the API")


if __name__ == "__main__":  # pragma: no cover
    main()
