"""The port's counterpart of tests/test_fleet.py: the JAX oracle's cases run
against baikaldb_tpu_torch on the CPU, and the cases at the end run the same
seeded work on both packages and compare.  The oracle's text follows.

Meta control loop commanding real raft replicas (the round-1 'meta
commands nothing' gap): dead-store migration moves a replica with its data;
trans_leader orders move real leadership."""

import pytest

from baikaldb_tpu_torch.meta.service import BalanceOrder, MetaService
from baikaldb_tpu_torch.raft.fleet import StoreFleet



class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def deploy():
    clock = FakeClock()
    meta = MetaService(faulty_after=15, dead_after=60, peer_count=3,
                       clock=clock)
    fleet = StoreFleet(meta, ["s1:8110", "s2:8110", "s3:8110", "s4:8110"])
    return meta, fleet, clock


def test_region_placement_and_heartbeat(deploy):
    meta, fleet, clock = deploy
    metas = fleet.create_table_regions(table_id=1, n_regions=2)
    assert all(len(m.peers) == 3 for m in metas)
    g = fleet.group(metas[0].region_id)
    assert g.put_row(g.bus.nodes[g.leader()], {"k": 1, "v": "a"})
    fleet.heartbeat_all()
    # meta sees the real leader + row counts
    rm = meta.regions[metas[0].region_id]
    assert rm.leader in rm.peers
    assert rm.num_rows == 1


def test_dead_store_migration_moves_data(deploy):
    meta, fleet, clock = deploy
    (rm,) = fleet.create_table_regions(table_id=1, n_regions=1)
    g = fleet.group(rm.region_id)
    for i in range(4):
        assert g.put_row(g.bus.nodes[g.leader()], {"k": i, "v": f"d{i}"})
    spare = next(a for a in fleet.addresses if a not in rm.peers)
    # kill a FOLLOWER store; its heartbeats stop
    leader_addr = fleet._addr[g.leader()]
    victim = next(p for p in rm.peers if p != leader_addr)
    fleet.kill_store(victim)
    clock.t = 10
    fleet.control_tick()          # victim still within faulty window
    clock.t = 100                 # past dead_after
    applied = fleet.control_tick()
    assert applied >= 1
    # meta's view moved the peer...
    assert victim not in meta.regions[rm.region_id].peers
    assert spare in meta.regions[rm.region_id].peers
    # ...and the REAL replica on the spare store has the data
    rep = fleet.replica(rm.region_id, spare)
    assert {r["k"] for r in rep.rows()} == {0, 1, 2, 3}
    # raft membership no longer includes the dead node
    assert fleet._ids[victim] not in g.peers()


def test_trans_leader_order_moves_leadership(deploy):
    meta, fleet, clock = deploy
    (rm,) = fleet.create_table_regions(table_id=1, n_regions=1)
    g = fleet.group(rm.region_id)
    old = fleet._addr[g.leader()]
    tgt = next(p for p in rm.peers if p != old)
    n = fleet.apply_orders([BalanceOrder("trans_leader", rm.region_id,
                                         target=tgt, source=old)])
    assert n == 1
    assert fleet._addr[g.bus.leader()] == tgt
    # group still writable after the transfer
    assert g.put_row(g.bus.nodes[g.leader()], {"k": 50, "v": "post"})


# -- differential: the same placement and orders on the JAX package ---------

def _fleet_trace(meta_mod, fleet_mod):
    clock = FakeClock()
    meta = meta_mod.MetaService(faulty_after=15, dead_after=60, peer_count=3, clock=clock)
    fleet = fleet_mod.StoreFleet(meta, ["s1:8110", "s2:8110", "s3:8110", "s4:8110"])
    metas = fleet.create_table_regions(table_id=1, n_regions=3)
    out = [("placed", [(m.region_id, sorted(m.peers)) for m in metas])]
    fleet.heartbeat_all()
    out.append(("leaders", [meta.regions[m.region_id].leader for m in metas]))
    victim = metas[0].peers[0]
    fleet.kill_store(victim)
    clock.t = 10
    out.append(("faulty", fleet.control_tick()))
    clock.t = 100
    out.append(("dead", fleet.control_tick()))
    out.append(("after", [(m.region_id, sorted(meta.regions[m.region_id].peers))
                          for m in metas]))
    return out


def test_placement_and_dead_store_orders_match_jax():
    import baikaldb_tpu.meta.service as jmeta
    import baikaldb_tpu.raft.fleet as jfleet
    import baikaldb_tpu_torch.meta.service as tmeta
    import baikaldb_tpu_torch.raft.fleet as tfleet

    assert _fleet_trace(tmeta, tfleet) == _fleet_trace(jmeta, jfleet)
