"""The port's counterpart of tests/test_twopc.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

2PC across raft region groups (VERDICT r1 #5 'done when': a crash between
prepare and commit leaves no torn multi-region write; in-doubt recovery
queries the primary)."""

import pytest

from baikaldb_tpu_torch.raft import RaftGroup
from baikaldb_tpu_torch.raft.twopc import (TwoPhaseCoordinator, TwoPhaseError,
                                     recover_all, resolve_in_doubt)



def make_groups(n=2):
    return [RaftGroup(region_id=i + 1, peer_ids=[i * 10 + 1, i * 10 + 2,
                                                 i * 10 + 3], seed=i + 3)
            for i in range(n)]


def rows_of(g):
    return {r["k"]: r["v"] for r in g.bus.nodes[g.leader()].rows()}


def ops_for(g, rows):
    rep = g.bus.nodes[g.leader()]
    out = []
    for k, v in rows:
        row = {"k": k, "v": v}
        out.append((0, rep.table.key_codec.encode_one(row),
                    rep.table.row_codec.encode(row)))
    return out


def test_commit_both_regions():
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    co.write({1: ops_for(g1, [(1, "a")]), 2: ops_for(g2, [(9, "z")])})
    assert rows_of(g1) == {1: "a"} and rows_of(g2) == {9: "z"}
    # prepared state drained everywhere
    for g in (g1, g2):
        assert not g.bus.nodes[g.leader()].prepared


def test_crash_before_decision_rolls_back():
    """Coordinator dies after prepare fan-out: no decision on the primary ->
    recovery aborts everywhere, neither region shows the write."""
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    txn = co.write({1: ops_for(g1, [(1, "torn")]),
                    2: ops_for(g2, [(2, "torn")])}, crash_after="prepare")
    # both prepared, nothing applied
    assert txn in g1.bus.nodes[g1.leader()].prepared
    assert txn in g2.bus.nodes[g2.leader()].prepared
    assert rows_of(g1) == {} and rows_of(g2) == {}
    out = recover_all([g1, g2], primary=g1)
    assert out[txn] == "rolled_back"
    assert rows_of(g1) == {} and rows_of(g2) == {}
    assert not g1.bus.nodes[g1.leader()].prepared
    assert not g2.bus.nodes[g2.leader()].prepared


def test_crash_after_primary_commit_completes():
    """Coordinator dies after the primary committed: the decision record is
    the source of truth -> recovery COMPLETES the secondary. No torn state."""
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    txn = co.write({1: ops_for(g1, [(1, "done")]),
                    2: ops_for(g2, [(2, "done")])}, crash_after="primary")
    assert rows_of(g1) == {1: "done"}           # primary applied
    assert rows_of(g2) == {}                    # secondary in doubt
    assert resolve_in_doubt(g2, g1, txn) == "committed"
    assert rows_of(g2) == {2: "done"}


def test_prepare_failure_aborts_all():
    g1, g2 = make_groups(2)
    ops1 = ops_for(g1, [(1, "x")])
    ops2 = ops_for(g2, [(2, "x")])
    # take region 2's quorum down: prepare there cannot commit
    for nid in list(g2.bus.nodes)[1:]:
        g2.bus.kill(nid)
    co = TwoPhaseCoordinator([g1, g2])
    with pytest.raises(TwoPhaseError):
        co.write({1: ops1, 2: ops2})
    assert rows_of(g1) == {}
    assert not g1.bus.nodes[g1.leader()].prepared


def test_in_doubt_survives_secondary_leader_change():
    """The prepared txn is raft state: a leader change on the in-doubt
    secondary must not lose it, and recovery still completes it."""
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    txn = co.write({1: ops_for(g1, [(1, "v")]), 2: ops_for(g2, [(2, "v")])},
                   crash_after="primary")
    old = g2.leader()
    g2.bus.kill(old)
    new = g2.bus.elect()
    assert new != old
    assert txn in g2.bus.nodes[new].prepared    # replicated, not lost
    assert resolve_in_doubt(g2, g1, txn) == "committed"
    assert rows_of(g2) == {2: "v"}


def _replica_rows(g):
    """rows as seen by EVERY live replica (keyed by node id)."""
    out = {}
    for nid, node in g.bus.nodes.items():
        if nid not in g.bus.down:
            out[nid] = {r["k"]: r["v"] for r in node.rows()}
    return out


def test_participant_failover_during_prepare_with_conflicting_txn():
    """VERDICT r02 weak #8: the participant's LEADER dies while the txn is
    prepared-but-undecided, a second conflicting txn commits through the
    failed-over group, and in-doubt recovery (query the primary,
    region.cpp:684) must roll back txn 1 without touching txn 2's data."""
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    t1 = co.write({1: ops_for(g1, [(1, "old")]), 2: ops_for(g2, [(5, "old")])},
                  crash_after="prepare")       # coordinator dies, no decision
    old = g2.leader()
    g2.bus.kill(old)
    assert g2.bus.elect() != old
    # a CONCURRENT conflicting txn on the same keys commits normally
    # through the failed-over participant
    co2 = TwoPhaseCoordinator([g1, g2])
    co2.write({1: ops_for(g1, [(1, "new")]), 2: ops_for(g2, [(5, "new")])})
    # recovery resolves txn1 against the primary: no decision -> rollback
    out = recover_all([g1, g2], primary=g1)
    assert out[t1] == "rolled_back"
    assert rows_of(g1) == {1: "new"} and rows_of(g2) == {5: "new"}
    # every live replica of the failed-over group agrees (same log)
    first, *rest = _replica_rows(g2).values()
    assert all(v == first for v in rest)
    for g in (g1, g2):
        assert not g.bus.nodes[g.leader()].prepared


def test_decision_record_first_writer_wins():
    """A late ABORT decision must not overwrite a landed COMMIT decision:
    recovery may already have committed a prepare from it (ADVICE r03
    medium — the torn-transaction window)."""
    from baikaldb_tpu_torch.raft.cluster import CMD_DECIDE, CMD_COMMIT, CMD_ROLLBACK

    (g1,) = make_groups(1)
    assert g1.propose_cmd(CMD_DECIDE, 77, bytes([CMD_COMMIT]))
    assert g1.propose_cmd(CMD_DECIDE, 77, bytes([CMD_ROLLBACK]))
    assert g1.bus.nodes[g1.leader()].decisions[77] == CMD_COMMIT


def test_lost_decide_ack_still_commits():
    """The DECIDE propose 'fails' (ack lost) but the record actually
    committed: the coordinator's abort attempt loses first-writer-wins, it
    reads back COMMIT, and the txn completes committed — never torn."""
    from baikaldb_tpu_torch.raft.cluster import CMD_DECIDE, CMD_COMMIT

    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    real = g1.propose_cmd

    def lossy(cmd, txn_id, ops_bytes=b"", max_ticks=400):
        ok = real(cmd, txn_id, ops_bytes, max_ticks)
        if cmd == CMD_DECIDE and ops_bytes == bytes([CMD_COMMIT]):
            return False                      # the ack is lost, not the entry
        return ok

    g1.propose_cmd = lossy
    txn = co.write({1: ops_for(g1, [(1, "kept")]),
                    2: ops_for(g2, [(2, "kept")])})
    g1.propose_cmd = real
    assert rows_of(g1) == {1: "kept"} and rows_of(g2) == {2: "kept"}
    assert resolve_in_doubt(g2, g1, txn) == "committed"  # idempotent


def test_failed_decide_aborts_via_explicit_record():
    """The DECIDE genuinely never commits: the coordinator replicates an
    explicit ABORT record, rolls prepares back, and recovery agrees."""
    from baikaldb_tpu_torch.raft.cluster import CMD_DECIDE, CMD_COMMIT, CMD_ROLLBACK

    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    real = g1.propose_cmd

    def drop_commit_decide(cmd, txn_id, ops_bytes=b"", max_ticks=400):
        if cmd == CMD_DECIDE and ops_bytes == bytes([CMD_COMMIT]):
            return False                      # entry really dropped
        return real(cmd, txn_id, ops_bytes, max_ticks)

    g1.propose_cmd = drop_commit_decide
    with pytest.raises(TwoPhaseError):
        co.write({1: ops_for(g1, [(1, "no")]), 2: ops_for(g2, [(2, "no")])})
    g1.propose_cmd = real
    assert rows_of(g1) == {} and rows_of(g2) == {}
    assert not g1.bus.nodes[g1.leader()].prepared
    assert not g2.bus.nodes[g2.leader()].prepared
    # the abort record is authoritative for any straggler recovery
    assert g1.bus.nodes[g1.leader()].decisions.get(
        list(g1.bus.nodes[g1.leader()].decisions)[-1]) == CMD_ROLLBACK


def test_in_doubt_decide_leaves_prepares_for_recovery():
    """Neither the COMMIT nor the ABORT decision can be confirmed: prepares
    must be LEFT ALONE (rolling them back could tear a txn whose commit
    decision actually landed)."""
    from baikaldb_tpu_torch.raft.cluster import CMD_DECIDE

    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    real = g1.propose_cmd

    def no_decides(cmd, txn_id, ops_bytes=b"", max_ticks=400):
        if cmd == CMD_DECIDE:
            return False
        return real(cmd, txn_id, ops_bytes, max_ticks)

    g1.propose_cmd = no_decides
    with pytest.raises(TwoPhaseError):
        co.write({1: ops_for(g1, [(1, "?")]), 2: ops_for(g2, [(2, "?")])})
    g1.propose_cmd = real
    # prepares intact on both groups, nothing applied
    t = list(g1.bus.nodes[g1.leader()].prepared)[-1]
    assert t in g2.bus.nodes[g2.leader()].prepared
    assert rows_of(g1) == {} and rows_of(g2) == {}
    # recovery later resolves from the (absent) decision: rollback
    assert resolve_in_doubt(g2, g1, t) == "rolled_back"
    assert resolve_in_doubt(g1, g1, t) == "rolled_back"
    assert not g1.bus.nodes[g1.leader()].prepared
    assert not g2.bus.nodes[g2.leader()].prepared


def test_prepared_at_restarts_after_snapshot_install():
    """prepare wall-times are not in the snapshot; install must stamp its
    own time so the in-doubt grace window restarts instead of never
    starting (ADVICE r03 low #1)."""
    (g1,) = make_groups(1)
    co = TwoPhaseCoordinator([g1])
    txn = co.write({1: ops_for(g1, [(1, "x")])}, crash_after="prepare")
    ldr = g1.bus.nodes[g1.leader()]
    assert txn in ldr.prepared and txn in ldr.prepared_at
    blob = ldr.snapshot_bytes()
    import copy

    fresh = copy.copy(ldr)
    fresh._install_snapshot(blob)
    assert txn in fresh.prepared
    assert txn in fresh.prepared_at      # stamped at install time


def test_decided_txn_wins_over_interleaved_write_deterministically():
    """Decision landed before the participant failover: recovery COMMITS the
    buffered prepare, which applies after an interleaved direct write —
    the same order on every replica (the log decides, not wall clock)."""
    g1, g2 = make_groups(2)
    co = TwoPhaseCoordinator([g1, g2])
    txn = co.write({1: ops_for(g1, [(1, "txn")]), 2: ops_for(g2, [(5, "txn")])},
                   crash_after="primary")      # decision + primary commit done
    old = g2.leader()
    g2.bus.kill(old)
    assert g2.bus.elect() != old
    # interleaved single-region write on the same key BEFORE resolution
    assert g2.write(ops_for(g2, [(5, "interleaved")]))
    assert rows_of(g2) == {5: "interleaved"}
    assert resolve_in_doubt(g2, g1, txn) == "committed"
    # the buffered txn ops apply at COMMIT position in the log: they win,
    # identically on every replica
    assert rows_of(g2) == {5: "txn"}
    first, *rest = _replica_rows(g2).values()
    assert all(v == first for v in rest)


# -- differential: the same transactions on the JAX package ------------------

def _run(raft_mod, twopc_mod, fail_second: bool):
    groups = [raft_mod.RaftGroup(region_id=i + 1, peer_ids=[i * 10 + 1, i * 10 + 2,
                                                            i * 10 + 3], seed=i + 3)
              for i in range(3)]
    co = twopc_mod.TwoPhaseCoordinator(groups)

    def ops(g, rows):
        rep = g.bus.nodes[g.leader()]
        return [(0, rep.table.key_codec.encode_one({"k": k, "v": v}),
                 rep.table.row_codec.encode({"k": k, "v": v})) for k, v in rows]

    co.write({1: ops(groups[0], [(1, "a")]), 3: ops(groups[2], [(3, "c")])})
    if fail_second:
        # the second region loses its quorum before the next transaction
        g = groups[1]
        for nid in list(g.bus.nodes)[:2]:
            g.bus.kill(nid)
    outcome = "committed"
    try:
        co.write({1: ops(groups[0], [(2, "b")]), 2: ops(groups[1], [(5, "e")])})
    except (twopc_mod.TwoPhaseError, RuntimeError) as e:
        outcome = f"aborted: {type(e).__name__}"
    rows = []
    for g in groups:
        try:
            ldr = g.leader()
        except RuntimeError:
            rows.append(None)
            continue
        rows.append(sorted((r["k"], r["v"]) for r in g.bus.nodes[ldr].rows()))
    return outcome, rows


@pytest.mark.parametrize("fail_second", [False, True])
def test_cross_region_outcomes_match_jax(fail_second):
    import baikaldb_tpu.raft as jraft
    import baikaldb_tpu.raft.twopc as jtwopc
    import baikaldb_tpu_torch.raft as traft
    import baikaldb_tpu_torch.raft.twopc as ttwopc

    got = _run(traft, ttwopc, fail_second)
    assert got == _run(jraft, jtwopc, fail_second)
    assert got[0].startswith("aborted" if fail_second else "committed")
