"""The port's counterpart of tests/test_raft.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

Raft consensus: election, replication, failover, snapshot, membership.

Drives the native deterministic core (native/raft.cpp) through the LocalBus
— the multi-node-without-a-cluster pattern (SURVEY §4), but covering the
election/partition paths the reference's braft-based tests cannot drive
deterministically.  The VERDICT r1 #4 'done when': a 3-peer cluster survives
leader kill with no acknowledged-write loss, and a peer-migration order
actually moves a replica."""

import pytest

from baikaldb_tpu_torch.raft import RaftGroup, ReplicatedRegion
from baikaldb_tpu_torch.raft.cluster import (CMD_WRITE, decode_ops,
                                       encode_cmd, encode_ops)
from baikaldb_tpu_torch.raft.core import LEADER



def _row(region, k, v):
    return {"k": k, "v": v}


def make_group(n=3, seed=7):
    return RaftGroup(region_id=1, peer_ids=list(range(1, n + 1)), seed=seed)


def test_single_node_commits_immediately():
    g = make_group(1)
    r = g.bus.nodes[1]
    assert g.put_row(r, {"k": 1, "v": "x"})
    assert r.rows() == [{"k": 1, "v": "x"}]


def test_election_and_replication():
    g = make_group(3)
    ldr = g.leader()
    assert ldr in (1, 2, 3)
    # exactly one leader among live nodes
    leaders = [n for n in g.bus.nodes.values() if n.core.role == LEADER]
    assert len(leaders) == 1
    r = g.bus.nodes[ldr]
    for i in range(5):
        assert g.put_row(r, {"k": i, "v": f"v{i}"})
    g.bus.advance(3)
    for node in g.bus.nodes.values():
        assert len(node.rows()) == 5, f"peer {node.node_id} lagging"


def test_leader_kill_no_acked_loss():
    g = make_group(3)
    ldr = g.leader()
    r = g.bus.nodes[ldr]
    acked = []
    for i in range(4):
        assert g.put_row(r, {"k": i, "v": f"a{i}"})
        acked.append(i)
    g.bus.kill(ldr)
    new_ldr = g.bus.elect()
    assert new_ldr != ldr
    rows = {row["k"] for row in g.bus.nodes[new_ldr].rows()}
    for k in acked:
        assert k in rows, f"acked write {k} lost after leader kill"
    # the group keeps accepting writes with 2/3 alive
    assert g.put_row(g.bus.nodes[new_ldr], {"k": 99, "v": "post"})


def test_deposed_leader_rejoins_and_catches_up():
    g = make_group(3)
    ldr = g.leader()
    assert g.put_row(g.bus.nodes[ldr], {"k": 1, "v": "one"})
    g.bus.kill(ldr)
    new_ldr = g.bus.elect()
    assert g.put_row(g.bus.nodes[new_ldr], {"k": 2, "v": "two"})
    g.bus.revive(ldr)
    g.bus.advance(10)
    assert {r["k"] for r in g.bus.nodes[ldr].rows()} == {1, 2}
    # old leader stepped down (higher term in the cluster)
    assert g.bus.nodes[ldr].core.role != LEADER or ldr == g.bus.leader()


def test_partition_minority_cannot_commit():
    g = make_group(3)
    ldr = g.leader()
    others = [n for n in g.bus.nodes if n != ldr]
    g.bus.partition([ldr], others)
    idx = g.bus.nodes[ldr].core.propose(
        encode_cmd(CMD_WRITE, 0, encode_ops([(0, b"k", b"v")])))
    pre = g.bus.nodes[ldr].core.commit_index
    g.bus.advance(30)
    assert g.bus.nodes[ldr].core.commit_index < max(idx, pre + 1) or idx < 0
    # majority side elects its own leader and can commit
    new_ldr = g.bus.elect()
    assert new_ldr in others
    assert g.put_row(g.bus.nodes[new_ldr], {"k": 5, "v": "maj"})
    # heal: minority leader steps down, converges to majority's log
    g.bus.heal()
    g.bus.advance(20)
    assert {r["k"] for r in g.bus.nodes[ldr].rows()} == {5}


def test_log_compaction_and_snapshot_install():
    g = make_group(3)
    ldr = g.leader()
    r = g.bus.nodes[ldr]
    for i in range(6):
        assert g.put_row(r, {"k": i, "v": f"s{i}"})
    # kill a follower, keep writing, compact the leader's log
    victim = next(n for n in g.bus.nodes if n != ldr)
    g.bus.kill(victim)
    for i in range(6, 10):
        assert g.put_row(r, {"k": i, "v": f"s{i}"})
    r.compact()
    assert r.core.first_index > 1
    # revived follower is behind the compacted log -> snapshot install
    g.bus.revive(victim)
    g.bus.advance(15)
    assert {row["k"] for row in g.bus.nodes[victim].rows()} == set(range(10))


def test_add_and_remove_peer_moves_replica():
    g = make_group(3)
    ldr = g.leader()
    for i in range(3):
        assert g.put_row(g.bus.nodes[ldr], {"k": i, "v": f"m{i}"})
    # migration order: add peer 4, then remove an old follower (the meta
    # balance add_peer/remove_peer pair, region_manager.h:90)
    assert g.add_peer(4)
    g.bus.advance(10)
    assert {r["k"] for r in g.bus.nodes[4].rows()} == {0, 1, 2}
    follower = next(n for n in list(g.bus.nodes) if n not in (ldr, 4))
    assert g.remove_peer(follower)
    assert follower not in g.bus.nodes
    assert sorted(g.peers()) == sorted(set(g.peers()))
    assert follower not in g.peers()
    # group still writable after migration
    assert g.put_row(g.bus.nodes[g.leader()], {"k": 77, "v": "post-move"})


def test_ops_codec_roundtrip():
    ops = [(0, b"a", b"1"), (1, b"bb", b""), (0, b"", b"xyz")]
    assert decode_ops(encode_ops(ops)) == ops


def test_read_barrier_after_failover():
    """Raft §8: a freshly elected leader exposes read_safe=False until an
    entry of ITS term commits; pumping the bus turns it True and the
    committed-by-the-old-leader write is applied and visible.  This is the
    barrier the store read paths gate on (a scan served in that window
    would silently miss acknowledged writes — the daemon-plane cold-tier
    flake this pins down)."""
    g = make_group(3)
    ldr = g.leader()
    assert g.put_row(g.bus.nodes[ldr], {"k": 1, "v": "acked"})
    g.bus.kill(ldr)
    new_ldr = g.bus.elect()
    node = g.bus.nodes[new_ldr]
    # pump until the new term's no-op commits; must happen quickly
    for _ in range(400):
        if node.core.read_safe:
            break
        g.bus.advance(1)
    assert node.core.read_safe
    node.apply_committed()
    assert {r["k"] for r in node.rows()} == {1}


def test_read_safe_single_node():
    g = make_group(1)
    r = g.bus.nodes[1]
    assert g.put_row(r, {"k": 1, "v": "x"})
    assert r.core.read_safe


# -- differential: the same seeded group on the JAX package -----------------

def _trace(mod_raft, mod_core, seed):
    """Elect, write, kill the leader, re-elect, write, revive: the leaders,
    terms, commit indices and every replica's rows along the way."""
    g = mod_raft.RaftGroup(region_id=1, peer_ids=[1, 2, 3], seed=seed)
    out = [("leader", g.leader())]
    r = g.bus.nodes[g.leader()]
    for i in range(4):
        assert g.put_row(r, {"k": i, "v": f"a{i}"})
    dead = g.leader()
    g.bus.kill(dead)
    ldr = g.bus.elect()
    out.append(("reelected", ldr, g.bus.nodes[ldr].core.term))
    for i in range(4, 7):
        assert g.put_row(g.bus.nodes[ldr], {"k": i, "v": f"b{i}"})
    g.bus.revive(dead)
    g.bus.advance(10)
    out.append(("commit", sorted((n, x.core.commit_index) for n, x in g.bus.nodes.items())))
    out.append(("rows", sorted((n, sorted(x.rows(), key=lambda r: r["k"]))
                               for n, x in g.bus.nodes.items())))
    out.append(("roles", sorted((n, x.core.role == mod_core.LEADER)
                                for n, x in g.bus.nodes.items())))
    return out


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_seeded_failover_matches_jax(seed):
    import baikaldb_tpu.raft as jraft
    import baikaldb_tpu.raft.core as jcore
    import baikaldb_tpu_torch.raft as traft
    import baikaldb_tpu_torch.raft.core as tcore

    assert _trace(traft, tcore, seed) == _trace(jraft, jcore, seed)
