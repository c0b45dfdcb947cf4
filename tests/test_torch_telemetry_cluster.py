"""The port's telemetry scrape (obs/telemetry.py) over its store daemons
(server/store_server.py), against the JAX package's.

``tests/test_telemetry.py``'s cluster cases on the port: real in-process
store daemons scraped over RPC into ``information_schema.cluster_metrics``
(per-daemon raft gauges, histograms merged bucket-wise under
daemon='fleet', the frontend's own rows), a crashed daemon's last rows kept
and marked stale, SHOW STATUS ``cluster.*`` rows, the in-band Prometheus
text (scraped by the port's exporter, tools/metrics_export.py, and by the
repo's, a JAX-package client, to the same families and up rows), and the
background poller.  The port's daemons expose the JAX daemons' metric names
but the XLA artifact gauge; the meta daemon is scraped through discovery
(``attach_meta``) as a cluster-mode Database does; and the JAX package's
``information_schema.executables`` (its XLA executable cache) raises
``NotPortedError``.
"""

import time

import pytest

from baikaldb_tpu_torch.errors import NotPortedError
from baikaldb_tpu_torch.exec.session import Database, Session
from baikaldb_tpu_torch.server.store_server import StoreServer, schema_to_wire
from baikaldb_tpu_torch.types import Field, LType, Schema
from baikaldb_tpu_torch.utils.net import RpcClient


def _mk_store(sid: int, cls=StoreServer):
    s = cls(sid, "127.0.0.1:0", tick_interval=0.01)
    s.address = f"127.0.0.1:{s.rpc.port}"      # port 0 -> bound port
    s.start()
    return s


def _wait_leader(tel, addresses, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = tel.cluster_rows()
        leads = {r[0] for r in rows
                 if r[1] == "raft_leader" and r[4] == 1.0}
        if set(addresses) <= leads:
            return rows
        time.sleep(0.05)
    raise TimeoutError("regions never elected leaders")


@pytest.fixture()
def fleet():
    sch = Schema((Field("id", LType.INT64, False),
                  Field("v", LType.FLOAT64, True)))
    stores = [_mk_store(1), _mk_store(2)]
    for i, s in enumerate(stores, 1):
        c = RpcClient(s.address)
        assert c.call("create_region", region_id=i,
                      peers=[[s.store_id, s.address]],
                      fields=schema_to_wire(sch),
                      key_columns=["id"])["created"]
        c.close()
    sess = Session(Database("cpu"))
    for s in stores:
        sess.db.telemetry.register(s.address)
    yield sess, stores
    for s in stores:
        s.stop()


def test_cluster_metrics_merges_real_daemons(fleet):
    sess, stores = fleet
    addrs = [s.address for s in stores]
    rows = _wait_leader(sess.db.telemetry, addrs)
    daemons = {r[0] for r in rows}
    assert set(addrs) <= daemons and {"frontend", "fleet"} <= daemons

    # the same view through SQL
    out = sess.query("SELECT * FROM information_schema.cluster_metrics")
    by = {}
    for r in out:
        by.setdefault((r["daemon"], r["metric"], r["field"]), []).append(r)

    # raft state gauges per daemon: leader=1, lag present
    for a in addrs:
        assert by[(a, "raft_leader", "value")][0]["value"] == 1.0
        assert (a, "raft_apply_lag", "value") in by
        assert (a, "raft_proposal_queue", "value") in by
        assert (a, "region_rows", "value") in by
        assert by[(a, "up", "value")][0]["value"] == 1.0

    # rpc handler latency histograms merge bucket-wise into the fleet row:
    # each daemon served exactly one create_region
    per = [r for r in out if r["metric"] == "rpc_handler_ms"
           and r["labels"] == "method=create_region" and r["field"] == "count"]
    fleet_count = [r for r in per if r["daemon"] == "fleet"]
    daemon_counts = [r for r in per if r["daemon"] in addrs]
    assert len(daemon_counts) == 2
    assert fleet_count[0]["value"] == \
        sum(r["value"] for r in daemon_counts) == 2.0

    # frontend registry rows ride along (engine counters)
    assert ("frontend", "queries_total", "value") in by


def test_cluster_metrics_survives_daemon_down(fleet):
    sess, stores = fleet
    addrs = [s.address for s in stores]
    _wait_leader(sess.db.telemetry, addrs)
    stores[0].crash()
    out = sess.query("SELECT * FROM information_schema.cluster_metrics")
    dead = [r for r in out if r["daemon"] == stores[0].address]
    live = [r for r in out if r["daemon"] == stores[1].address]
    assert dead and all(r["stale"] == 1 for r in dead)     # last-known rows
    assert live and all(r["stale"] == 0 for r in live)
    up = {r["daemon"]: r["value"] for r in out if r["metric"] == "up"}
    assert up[stores[0].address] == 0.0 and up[stores[1].address] == 1.0
    # stale rows still carry the daemon's last-known raft state
    assert any(r["metric"] == "raft_leader" for r in dead)


def test_show_status_cluster_rows(fleet):
    sess, stores = fleet
    rows = sess.query("SHOW STATUS LIKE 'cluster.%'")
    vals = {r["Variable_name"]: r["Value"] for r in rows}
    for s in stores:
        assert vals[f"cluster.daemon.{s.address}.up"] == "1"
    # merged fleet counters present (daemon uptime counters are gauges and
    # must NOT appear; summed raft proposals counter family does)
    assert any(k.startswith("cluster.rpc_handler_ms") for k in vals)
    assert not any(k.startswith("cluster.uptime_s") for k in vals)


def test_daemon_prometheus_rpc_and_export_tool(fleet):
    sess, stores = fleet
    c = RpcClient(stores[0].address)
    text = c.call("prometheus")["text"]
    c.close()
    assert f'daemon="{stores[0].address}"' in text
    assert "# TYPE baikal_rpc_handler_ms histogram" in text
    # the port's exporter scrapes the port's daemons
    from baikaldb_tpu_torch.tools.metrics_export import scrape
    out = scrape([s.address for s in stores])
    assert 'daemon="fleet"' in out
    assert 'baikal_up{daemon="%s"} 1' % stores[0].address in out
    # fleet exposition: one TYPE declaration per metric name
    types = [ln for ln in out.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    # the repo's exporter (a JAX-package client) beside it: the same metric
    # families and the same up rows
    from tools.metrics_export import scrape as jax_scrape
    jout = jax_scrape([s.address for s in stores])

    def ups(text):
        return sorted(ln for ln in text.splitlines() if ln.startswith("baikal_up{"))
    assert set(types) == {ln for ln in jout.splitlines() if ln.startswith("# TYPE")}
    assert ups(out) == ups(jout) and len(ups(out)) == len(stores)


def test_telemetry_background_poller(fleet):
    sess, stores = fleet
    tel = sess.db.telemetry
    tel.start(interval_s=0.05)
    try:
        time.sleep(0.3)
        assert tel.running()
        # cache is fresh without an inline poll
        ents = tel.entries(refresh=True)    # refresh no-ops while running
        assert all(e["ok"] for e in ents.values())
    finally:
        tel.stop()
    assert not tel.running()


def _names(rows, daemon):
    return {(r[1], r[3]) for r in rows if r[0] == daemon}


def test_daemon_metric_names_match_jax(fleet):
    """A port store daemon and a JAX one, each with one region, expose the
    same metric families and fields, but the JAX daemon's XLA artifact
    gauge."""
    from baikaldb_tpu.server.store_server import StoreServer as JStore
    from baikaldb_tpu.server.store_server import schema_to_wire as jwire
    from baikaldb_tpu.types import Field as JField
    from baikaldb_tpu.types import LType as JLType
    from baikaldb_tpu.types import Schema as JSchema

    sess, stores = fleet
    j = _mk_store(9, JStore)
    try:
        sch = JSchema((JField("id", JLType.INT64, False), JField("v", JLType.FLOAT64, True)))
        c = RpcClient(j.address)    # the port's client, the JAX daemon
        assert c.call("create_region", region_id=9, peers=[[j.store_id, j.address]],
                      fields=jwire(sch), key_columns=["id"])["created"]
        c.close()
        sess.db.telemetry.register(j.address)
        rows = _wait_leader(sess.db.telemetry, [stores[0].address, j.address])
        want = {n for n in _names(rows, j.address) if n[0] != "aot_artifacts_hosted"}
        assert _names(rows, stores[0].address) == want
    finally:
        sess.db.telemetry.unregister(j.address)
        j.stop()


def test_meta_discovery_scrapes_every_daemon():
    """``attach_meta``: the meta daemon and the stores registered with it
    join the scrape set, as in a cluster-mode Database."""
    from baikaldb_tpu_torch.server.meta_server import MetaServer

    meta = MetaServer("127.0.0.1:0")
    meta.start()
    meta_addr = f"127.0.0.1:{meta.rpc.port}"
    stores = []
    try:
        for sid in (1, 2):
            st = StoreServer(sid, "127.0.0.1:0", meta_addr, tick_interval=0.02)
            st.address = f"127.0.0.1:{st.rpc.port}"
            st.start()
            stores.append(st)
        sess = Session(Database("cpu"))
        sess.db.telemetry.attach_meta(meta_addr)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            got = {r["daemon"] for r in sess.query(
                "SELECT daemon FROM information_schema.cluster_metrics WHERE metric = 'up'")}
            if {meta_addr, *(s.address for s in stores)} <= got:
                break
            time.sleep(0.1)
        assert {meta_addr, *(s.address for s in stores)} <= got
        roles = RpcClient(meta_addr).call("metrics")
        assert roles["role"] == "meta" and "meta_instances" in roles["metrics"]
    finally:
        for st in stores:
            st.stop()
        meta.stop()


@pytest.mark.parametrize("name", ["executables", "aot_cache"])
def test_xla_executable_views_have_no_counterpart(name):
    s = Session(device="cpu")
    with pytest.raises(NotPortedError, match="XLA"):
        s.query(f"SELECT * FROM information_schema.{name}")
