"""Incrementally maintained rollup views (CREATE MATERIALIZED VIEW).

The port of ``baikaldb_tpu/cdc/views.py`` (copied; it imports the port's
rollup, TSO, metrics and failpoints).  A view's seed and its group rescans
are GROUP BYs over the base table run through the session, so on the card
they launch the ported group kernels as any GROUP BY does.

The reference pairs its binlog subscription SDK with a pre-aggregated
rollup index (I_ROLLUP, maintained in region_olap.cpp).  Here the two
halves meet: a materialized view's state IS the mergeable partial-agg
layout the rollup index already uses (index/rollup.rollup_schema —
cnt_star plus cnt/sum/min/max per measure, *Partial Partial Aggregates*:
partials are mergeable by construction), and a maintenance pass folds
insert/delete/update deltas from the view's change stream
(cdc/streams.Subscription) into that state instead of recomputing:

- insert row  -> +1 into its group's partials,
- delete row  -> -1 (retract); a retract that touches a group's current
  MIN/MAX re-scans just that group from the base table (min/max are not
  invertible),
- update row  -> retract old image + fold new image,
- statement-image events (bulk INSERT..SELECT summaries, DDL, updates
  whose row images weren't captured) -> one full re-seed from the base.

Exactly-once: the fold applies events with ``commit_ts > applied_ts``
only, advances ``applied_ts`` per event, and acks AFTER applying — a
crash (or the cdc.apply failpoint) between apply and ack redelivers the
batch and the applied_ts dedupe absorbs it.

Answering: the planner maps a matching GROUP BY SELECT onto the hidden
``__mv_*`` table through the SAME rewrite the rollup index uses
(index/rollup.try_rewrite with target_table=...), so the rewritten query
runs through the ordinary engine — the off-switch (``matview_answer=0``)
is bit-identical because both arms execute engine SQL, and measures are
restricted to integer columns so delta folding is exact (no
float-reassociation drift between the fold and a recompute).

Staleness is first-class: ``applied commit_ts`` vs the table high-water
commit_ts, in TSO-physical milliseconds, surfaced in
information_schema.materialized_views and the EXPLAIN ANALYZE
``-- view:`` line.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..chaos import failpoint
from ..index.rollup import refresh_sql, rollup_schema
from ..meta.tso import Tso
from ..utils import metrics
from ..utils.flags import define
from .streams import CursorLagging

define("matview_answer", True,
       "answer matching GROUP BY queries from materialized-view state "
       "(off: always recompute from the base table — bit-identical)")
define("matview_auto_maintain", True,
       "fold pending change-stream deltas into a materialized view "
       "before answering from it (off: answers serve the last folded "
       "state and staleness grows)")

MV_PREFIX = "__mv_"


def mv_table_name(name: str) -> str:
    return f"{MV_PREFIX}{name}"


def is_mv_table(name: str) -> bool:
    return name.startswith(MV_PREFIX)


def _sql_lit(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    return str(int(v))


class MatView:
    """One registered view: parsed shape + folded partial state + cursor."""

    def __init__(self, db, database: str, name: str, sql: str,
                 base_db: str, base_table: str,
                 keys: list[str], measures: list[str]):
        self.db = db
        self.database = database
        self.name = name
        self.sql = sql
        self.base_db = base_db
        self.base_table = base_table
        self.keys = list(keys)
        self.measures = list(measures)
        self.hidden = mv_table_name(name)
        self.partial_cols = ["cnt_star"]
        for v in self.measures:
            self.partial_cols += [f"cnt_{v}", f"sum_{v}",
                                  f"min_{v}", f"max_{v}"]
        # state: group key tuple -> {partial col -> value}; None until the
        # first maintain() seeds it (and after recovery: rebuilt lazily)
        self.state: Optional[dict] = None
        self.applied_ts = 0
        self.state_gen = 0
        self._mat_gen = -1
        self.deltas_folded = 0
        self.rescans = 0
        self.answered = 0
        self._mu = threading.RLock()

    # -- identity ----------------------------------------------------------
    @property
    def base_key(self) -> str:
        return f"{self.base_db}.{self.base_table}"

    @property
    def sub_name(self) -> str:
        return f"__mv!{self.database}.{self.name}"

    def subscription(self):
        return self.db.cdc.create(self.sub_name, table_key=self.base_key,
                                  internal=True, if_not_exists=True,
                                  since_ts=0)

    def staleness_ms(self) -> int:
        hw = self.db.binlog.current_ts()
        if not hw or hw <= self.applied_ts:
            return 0
        return ((hw >> Tso.LOGICAL_BITS)
                - (self.applied_ts >> Tso.LOGICAL_BITS))

    # -- maintenance -------------------------------------------------------
    def maintain(self, session) -> None:
        """Drain the view's change stream into the partial state:
        apply-then-ack with an applied_ts dedupe (exactly-once), bounded
        rounds so a firehose can't wedge the reader."""
        with self._mu:
            if self.state is None:
                self._rebuild(session)
            sub = self.subscription()
            for _round in range(64):
                try:
                    events = sub.fetch()
                except CursorLagging:
                    # events were GC'd past this view's cursor: the only
                    # consistent move is a full re-seed from the base
                    self._rebuild(session)
                    continue
                if not events:
                    break
                from ..obs import trace

                with trace.span("view.fold", view=self.name,
                                events=len(events)):
                    if failpoint.ENABLED:
                        if failpoint.hit("view.fold", view=self.name):
                            # round abandoned BEFORE any state change:
                            # nothing acked, staleness grows, state stays
                            # consistent
                            break
                    folded = self._fold_batch(session, events)
                if folded:
                    metrics.view_folds.add(1)
                    metrics.view_deltas_folded.add(folded)
                    self.deltas_folded += folded
                    self.state_gen += 1
                # ack AFTER applying (the cdc.apply failpoint models a
                # crash in between: the batch redelivers, the applied_ts
                # dedupe in _fold_batch absorbs it)
                sub.ack(self.applied_ts)

    def _fold_batch(self, session, events) -> int:
        folded = 0
        rescan_all = False
        dirty: set = set()
        for ev in events:
            if ev.commit_ts <= self.applied_ts:
                continue            # redelivered (ack lost): exactly-once
            try:
                r = self._apply_event(ev, dirty)
            except Exception:       # noqa: BLE001 — malformed image
                r = "rescan"
            if r == "rescan":
                rescan_all = True
            self.applied_ts = ev.commit_ts
            folded += 1
        if rescan_all:
            # re-seed covers every event we just advanced past (its ts0 is
            # taken at/after the newest of them)
            self._rebuild(session)
        elif dirty:
            metrics.view_rescans.add(len(dirty))
            self.rescans += len(dirty)
            for key in dirty:
                self._rescan_group(session, key)
            self.state_gen += 1
        return folded

    def _apply_event(self, ev, dirty: set) -> Optional[str]:
        if ev.event_type == "truncate":
            self.state = {}
            return None
        if ev.event_type in ("insert", "delete"):
            if not ev.rows:
                return "rescan" if ev.affected or ev.statement else None
            sign = 1 if ev.event_type == "insert" else -1
            for row in ev.rows:
                if self._fold_row(row, sign) == "rescan":
                    return "rescan"
            return None
        if ev.event_type == "update":
            if not ev.rows:
                return "rescan" if ev.affected or ev.statement else None
            for pair in ev.rows:
                old, new = pair.get("old"), pair.get("new")
                if old is None or new is None:
                    return "rescan"     # statement image, no row pair
                if self._fold_row(old, -1, dirty) == "rescan":
                    return "rescan"
                if self._fold_row(new, 1, dirty) == "rescan":
                    return "rescan"
            return None
        return "rescan"                 # ddl / unknown event kinds

    def _fold_row(self, row: dict, sign: int,
                  dirty: Optional[set] = None) -> Optional[str]:
        if not isinstance(row, dict):
            return "rescan"
        key = tuple(row.get(k) for k in self.keys)
        st = self.state.get(key)
        if st is None:
            if sign < 0:
                return "rescan"         # retract from a group we never saw
            st = {"cnt_star": 0}
            for v in self.measures:
                st.update({f"cnt_{v}": 0, f"sum_{v}": None,
                           f"min_{v}": None, f"max_{v}": None})
            self.state[key] = st
        st["cnt_star"] += sign
        if st["cnt_star"] < 0:
            return "rescan"
        for v in self.measures:
            val = row.get(v)
            if val is None:
                continue
            val = int(val)
            st[f"cnt_{v}"] += sign
            st[f"sum_{v}"] = (st[f"sum_{v}"] or 0) + sign * val
            if sign > 0:
                mn, mx = st[f"min_{v}"], st[f"max_{v}"]
                st[f"min_{v}"] = val if mn is None else min(mn, val)
                st[f"max_{v}"] = val if mx is None else max(mx, val)
            else:
                # MIN/MAX are not invertible: retracting the current
                # extremum re-scans just this group from the base
                if val in (st[f"min_{v}"], st[f"max_{v}"]):
                    if dirty is None:
                        return "rescan"
                    dirty.add(key)
            if st[f"cnt_{v}"] == 0:
                st[f"sum_{v}"] = None
                st[f"min_{v}"] = None
                st[f"max_{v}"] = None
            elif st[f"cnt_{v}"] < 0:
                return "rescan"
        if st["cnt_star"] == 0:
            del self.state[key]
            if dirty is not None:
                dirty.discard(key)
        return None

    def _agg_select(self) -> str:
        parts = ["COUNT(*) cnt_star"]
        for v in self.measures:
            parts += [f"COUNT({v}) cnt_{v}", f"SUM({v}) sum_{v}",
                      f"MIN({v}) min_{v}", f"MAX({v}) max_{v}"]
        return ", ".join(parts)

    def _rescan_group(self, session, key: tuple) -> None:
        conds = [f"{k} IS NULL" if v is None else f"{k} = {_sql_lit(v)}"
                 for k, v in zip(self.keys, key)]
        sql = (f"SELECT {self._agg_select()} FROM {self.base_key} "
               f"WHERE {' AND '.join(conds)}")
        row = self._run_internal(session, sql)[0]
        if not row["cnt_star"]:
            self.state.pop(key, None)
        else:
            self.state[key] = {c: row[c] for c in self.partial_cols}

    def _rebuild(self, session) -> None:
        """Full re-seed from the base table (CREATE, CursorLagging,
        statement-image events).  ts0 is captured before the scan and the
        scan retries while the base version moves underneath it, so the
        (ts0, state) pair is consistent at a quiesced point — the
        documented contract for exactness (see docs/CDC.md)."""
        store = self.db.stores[self.base_key]
        sql = refresh_sql(self.base_key, self.hidden, self.keys,
                          self.measures)
        for _attempt in range(5):
            v0 = store.version
            ts0 = self.db.binlog.current_ts()
            rows = self._run_internal(session, sql)
            if store.version == v0:
                break
        state: dict = {}
        for r in rows:
            key = tuple(r[k] for k in self.keys)
            state[key] = {c: r[c] for c in self.partial_cols}
        self.state = state
        self.applied_ts = ts0
        self.state_gen += 1
        self.subscription().seek(ts0)
        metrics.view_rescans.add(1)
        self.rescans += 1

    def _run_internal(self, session, sql: str) -> list[dict]:
        """Engine query with the matview/rollup rewrites disabled — the
        seed and rescans must read the BASE table."""
        prev = getattr(session, "_in_mv_refresh", False)
        session._in_mv_refresh = True
        try:
            table = session._execute(sql).arrow
        finally:
            session._in_mv_refresh = prev
        return table.to_pylist() if table is not None else []

    # -- hidden-table materialization -------------------------------------
    def materialize(self, session) -> None:
        """Flush folded state into the hidden ``__mv_*`` store (only when
        the state generation moved) so the planner-rewritten SQL reads
        current partials."""
        import pyarrow as pa

        from ..storage.column_store import schema_to_arrow

        with self._mu:
            if self._mat_gen == self.state_gen or self.state is None:
                return
            store = self.db.stores[f"{self.database}.{self.hidden}"]
            store.truncate()
            if self.state:
                rinfo = self.db.catalog.get_table(self.database, self.hidden)
                asch = schema_to_arrow(rinfo.schema)
                cols: dict[str, list] = {f.name: []
                                         for f in rinfo.schema.fields}
                for key, st in self.state.items():
                    for i, k in enumerate(self.keys):
                        cols[k].append(key[i])
                    for c in self.partial_cols:
                        cols[c].append(st[c])
                tbl = pa.table({n: pa.array(vs, type=asch.field(n).type)
                                for n, vs in cols.items()})
                store.insert_arrow(tbl, session._tctx(store))
            self._mat_gen = self.state_gen

    def describe(self) -> dict:
        sub = self.db.cdc.subs.get(self.sub_name)
        return {"database": self.database, "name": self.name,
                "base_table": self.base_key, "definition": self.sql,
                "applied_ts": self.applied_ts,
                "staleness_ms": self.staleness_ms(),
                "cursor_lag_ms": sub.lag_ms() if sub else 0,
                "deltas_folded": self.deltas_folded,
                "rescans": self.rescans,
                "answered_queries": self.answered,
                "groups": len(self.state) if self.state is not None else -1}


class MatViews:
    """Per-database materialized-view registry (``db.matviews``)."""

    def __init__(self, db):
        self.db = db
        self.views: dict[str, MatView] = {}
        self._mu = threading.RLock()

    # -- DDL ---------------------------------------------------------------
    def create(self, session, database: str, name: str, select_sql: str,
               if_not_exists: bool = False) -> MatView:
        from ..exec.session import PlanError

        vkey = f"{database}.{name}"
        with self._mu:
            if vkey in self.views:
                if if_not_exists:
                    return self.views[vkey]
                raise PlanError(f"materialized view {vkey!r} exists")
            base_db, base_table, keys, measures = self._validate(
                session, database, select_sql)
            info = self.db.catalog.get_table(base_db, base_table)
            sch = rollup_schema(info.schema, keys, measures)
            hidden = mv_table_name(name)
            rinfo = self.db.catalog.create_table(database, hidden, sch, [])
            self.db.stores[f"{database}.{hidden}"] = \
                self.db.make_store(rinfo)
            mv = MatView(self.db, database, name, select_sql,
                         base_db, base_table, keys, measures)
            mv.subscription()       # registers the cursor + GC hold now
            self.views[vkey] = mv
            self.db.save_catalog()
            return mv

    def _validate(self, session, database: str, select_sql: str):
        from ..expr.ast import AggCall, ColRef
        from ..sql.parser import parse_sql
        from ..exec.session import PlanError
        from ..sql.stmt import SelectStmt

        stmts = parse_sql(select_sql)
        if len(stmts) != 1 or not isinstance(stmts[0], SelectStmt):
            raise PlanError("materialized view body must be one SELECT")
        s = stmts[0]
        if (s.joins or s.ctes or s.union or s.distinct or s.table is None
                or s.where is not None or s.having is not None
                or s.order_by or s.limit is not None):
            raise PlanError(
                "materialized view: single-table SELECT with GROUP BY "
                "only (no WHERE/HAVING/ORDER/LIMIT/JOIN/DISTINCT)")
        if not s.group_by:
            raise PlanError("materialized view needs a GROUP BY")
        base_db = s.table.database or database
        base_table = s.table.name
        if is_mv_table(base_table):
            raise PlanError("materialized view over a hidden table")
        info = self.db.catalog.get_table(base_db, base_table)
        keys = []
        for g in s.group_by:
            if not isinstance(g, ColRef) or g.name not in info.schema:
                raise PlanError("GROUP BY keys must be plain columns")
            lt = info.schema.field(g.name).ltype
            if not (lt.is_integer or lt.is_string):
                raise PlanError(
                    f"group key {g.name!r}: integer/string/bool keys only "
                    "(exact equality for delta folding)")
            keys.append(g.name)
        measures: list[str] = []
        for it in s.items:
            e = it.expr
            if isinstance(e, ColRef):
                if e.name not in keys:
                    raise PlanError(f"column {e.name!r} not in GROUP BY")
                continue
            if not isinstance(e, AggCall) or e.distinct:
                raise PlanError(
                    "view items must be group keys or plain aggregates")
            if e.op == "count_star" or (e.op == "count" and not e.args):
                continue
            if e.op not in ("count", "sum", "min", "max", "avg") \
                    or len(e.args) != 1 \
                    or not isinstance(e.args[0], ColRef):
                raise PlanError(
                    f"unsupported view aggregate {e.op!r}: "
                    "COUNT/SUM/MIN/MAX/AVG over a plain column")
            v = e.args[0].name
            if v not in info.schema:
                raise PlanError(f"unknown column {v!r}")
            if not info.schema.field(v).ltype.is_integer:
                raise PlanError(
                    f"measure {v!r}: integer measures only (delta folds "
                    "must be exact — float SUM is order-sensitive)")
            if v not in measures:
                measures.append(v)
        if not measures and not any(isinstance(it.expr, AggCall)
                                    for it in s.items):
            raise PlanError("materialized view needs an aggregate")
        return base_db, base_table, keys, measures

    def drop(self, session, database: str, name: str,
             if_exists: bool = False) -> bool:
        from ..exec.session import PlanError

        vkey = f"{database}.{name}"
        with self._mu:
            mv = self.views.pop(vkey, None)
            if mv is None:
                if if_exists:
                    return False
                raise PlanError(f"unknown materialized view {vkey!r}")
            self.db.cdc.drop(mv.sub_name, if_exists=True)
            hkey = f"{database}.{mv.hidden}"
            self.db.catalog.drop_table(database, mv.hidden, if_exists=True)
            st = self.db.stores.pop(hkey, None)
            session._drop_durable(hkey, st)
            self.db.save_catalog()
            return True

    def drop_for_base(self, session, table_key: str) -> None:
        """DROP TABLE cascade: retire views whose base went away."""
        with self._mu:
            victims = [v for v in self.views.values()
                       if v.base_key == table_key]
        for v in victims:
            self.drop(session, v.database, v.name, if_exists=True)

    # -- lookup ------------------------------------------------------------
    def get(self, database: str, name: str) -> Optional[MatView]:
        with self._mu:
            return self.views.get(f"{database}.{name}")

    def for_base(self, table_key: str) -> list[MatView]:
        with self._mu:
            return [v for v in self.views.values()
                    if v.base_key == table_key]

    def describe(self) -> list[dict]:
        with self._mu:
            views = list(self.views.values())
        return [v.describe() for v in
                sorted(views, key=lambda v: (v.database, v.name))]

    # -- catalog persistence ----------------------------------------------
    def to_meta(self) -> list[dict]:
        with self._mu:
            return [{"database": v.database, "name": v.name, "sql": v.sql,
                     "base_db": v.base_db, "base_table": v.base_table,
                     "keys": v.keys, "measures": v.measures}
                    for v in self.views.values()]

    def recover(self, meta: list[dict]) -> None:
        """Re-register from catalog.json: state rebuilds lazily on first
        use (the durable cursor says where the stream resumes; the seed
        re-scan makes the state exact regardless)."""
        for m in meta or []:
            mv = MatView(self.db, m["database"], m["name"], m["sql"],
                         m["base_db"], m["base_table"],
                         list(m["keys"]), list(m["measures"]))
            mv.subscription()   # re-arm the cursor + row-image capture gate
            with self._mu:
                self.views[f"{mv.database}.{mv.name}"] = mv
