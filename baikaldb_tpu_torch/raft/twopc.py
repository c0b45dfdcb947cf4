"""Two-phase commit across raft region groups.

The reference commits a multi-region DML by PREPARE fan-out, then COMMIT on
the PRIMARY region first, then the secondaries; a secondary crashing with a
prepared txn recovers by asking the primary whether the decision landed
(src/exec/fetcher_store.cpp:1848-1904 primary-first commit,
src/store/region.cpp:684 exec_txn_query_primary_region, transaction_pool.cpp
prepared-txn recovery).

Here each participant is a RaftGroup (raft-replicated itself, so "a region
crashed" means its quorum is gone or its coordinator died): PREPARE/COMMIT/
ROLLBACK are replicated commands in each group's log, and the commit
DECISION is a replicated record on the primary group — the single source of
truth for in-doubt resolution.

The port's copy of ``baikaldb_tpu/raft/twopc.py``, unchanged but for its
imports."""

from __future__ import annotations

import itertools
import threading

from ..chaos import failpoint
from .cluster import (CMD_COMMIT, CMD_DECIDE, CMD_PREPARE, CMD_ROLLBACK,
                      RaftGroup, encode_ops)

_txn_ids = itertools.count(1)
_txn_lock = threading.Lock()


def next_txn_id() -> int:
    with _txn_lock:
        return next(_txn_ids)


class TwoPhaseError(RuntimeError):
    pass


class TwoPhaseCoordinator:
    """Coordinates one multi-region write (the DML manager node analog).

    ``crash_after`` (test hook): "prepare" kills the coordinator after the
    prepare fan-out, "primary" after the primary commit — the two windows
    the reference's recovery protocol must cover."""

    def __init__(self, groups: list[RaftGroup]):
        if not groups:
            raise ValueError("need at least one participant")
        self.primary = groups[0]
        self.secondaries = groups[1:]
        self.groups = groups

    def write(self, per_group_ops: dict[int, list], crash_after: str = "",
              txn_id: int | None = None, commit_ts: int = 0) -> int:
        """ops per region_id; returns the txn id.  Raises TwoPhaseError on a
        failed prepare (everything rolled back).

        ``commit_ts``: the transaction's MVCC commit timestamp, stamped at
        DECIDE time — it rides the decision record's raft log entry as a
        trailing 8-byte field, so the one instant every region's versions
        become visible at is itself quorum-persisted.  Replica apply reads
        only ``body[0]`` (the outcome byte), so old snapshots/replicas
        decode the extended record unchanged."""
        from ..obs import trace

        txn = txn_id or next_txn_id()
        decide_commit = bytes([CMD_COMMIT])
        if commit_ts:
            import struct
            decide_commit += struct.pack("<Q", int(commit_ts))
        by_region = {g.region_id: g for g in self.groups}
        # phase 1: PREPARE everywhere (each is itself raft-committed)
        prepared = []
        with trace.span("2pc.prepare", txn=txn,
                        regions=len(per_group_ops)):
            for rid, ops in per_group_ops.items():
                g = by_region[rid]
                injected = False
                if failpoint.ENABLED:
                    # drop: this participant's prepare fails (rollback fan-
                    # out); return/panic raise mid-fan-out, leaving earlier
                    # prepares in doubt — the recovery protocol's window
                    injected = failpoint.hit("2pc.prepare", txn=txn,
                                             region=rid)
                if injected or \
                        not g.propose_cmd(CMD_PREPARE, txn, encode_ops(ops)):
                    for p in prepared:
                        p.propose_cmd(CMD_ROLLBACK, txn)
                    raise TwoPhaseError(f"prepare failed on region {rid}")
                prepared.append(g)
        if crash_after == "prepare":
            return txn                    # coordinator dies here
        # decision record + commit on the PRIMARY first: once this is in the
        # primary's log the txn is globally COMMITTED.  The decision propose
        # MUST be verified — acking a txn whose decision never reached
        # quorum would lose it (recovery would roll the prepares back).
        with trace.span("2pc.decide", txn=txn):
            dropped = False
            if failpoint.ENABLED:
                dropped = failpoint.hit("2pc.decide", txn=txn)
            decided = (not dropped) and \
                self.primary.propose_cmd(CMD_DECIDE, txn, decide_commit)
        if not decided:
            # A failed propose does NOT mean the decision failed to commit —
            # a timeout can lose the ack, not the entry.  Rolling prepares
            # back here could tear the txn (recovery commits a surviving
            # prepare from the landed decision while others rolled back —
            # ADVICE r03 medium).  Replicate an explicit ABORT decision
            # instead; the apply is first-writer-wins, so reading back the
            # WINNING decision tells us which outcome is authoritative.
            if not self.primary.propose_cmd(CMD_DECIDE, txn,
                                            bytes([CMD_ROLLBACK])):
                # can't even record the abort: leave every prepare in doubt
                # for recovery to resolve from whatever decision exists
                raise TwoPhaseError(
                    f"commit decision in doubt on primary region "
                    f"{self.primary.region_id}; prepares left for recovery")
            winner = self.primary.bus.nodes[
                self.primary.leader()].decisions.get(txn)
            if winner != CMD_COMMIT:
                # abort decision won: rollbacks are now safe (best-effort —
                # failures leave in-doubt prepares that recovery rolls back
                # from the abort record)
                for p in prepared:
                    p.propose_cmd(CMD_ROLLBACK, txn)
                raise TwoPhaseError(
                    f"commit decision failed on primary region "
                    f"{self.primary.region_id}")
            # the original commit decision actually landed: fall through —
            # the txn IS committed
        # past the decision point the txn is committed; the remaining
        # proposals are completion, not consensus — a failure here leaves an
        # in-doubt prepare that resolve_in_doubt finishes from the decision
        with trace.span("2pc.commit", txn=txn):
            self.primary.propose_cmd(CMD_COMMIT, txn)
            if crash_after == "primary":
                return txn                # coordinator dies here
            for g in self.secondaries:
                if g.region_id in per_group_ops:
                    g.propose_cmd(CMD_COMMIT, txn)
        return txn


def resolve_in_doubt(group: RaftGroup, primary: RaftGroup, txn_id: int) -> str:
    """Recovery for a prepared-but-undecided txn on ``group``: ask the
    primary (reference: region.cpp:598/684 — in-doubt secondaries query the
    primary region's txn state).  -> "committed" | "rolled_back"."""
    ldr = primary.bus.nodes[primary.leader()]
    decision = ldr.decisions.get(txn_id)
    if decision == CMD_COMMIT:
        group.propose_cmd(CMD_COMMIT, txn_id)
        return "committed"
    # explicit abort decision, or no decision at all (the coordinator died
    # before the commit point): the txn must abort everywhere (the
    # primary's own prepare, if any, rolls back too)
    for g in (group, primary):
        if txn_id in g.bus.nodes[g.leader()].prepared:
            g.propose_cmd(CMD_ROLLBACK, txn_id)
    return "rolled_back"


def recover_all(groups: list[RaftGroup], primary: RaftGroup) -> dict[int, str]:
    """Resolve every in-doubt txn across ``groups`` against the primary."""
    out: dict[int, str] = {}
    for g in groups:
        ldr = g.bus.nodes[g.leader()]
        for txn in sorted(list(ldr.prepared)):
            out[txn] = resolve_in_doubt(g, primary, txn)
    return out
