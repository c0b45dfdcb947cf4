"""The port's chaos scenarios (chaos/scenarios.py) and runner
(tools/chaos_run.py) against the JAX package's.

Every scenario runs in the port on the CPU (``device="cpu"``) and must be
``ok``.  The five fleet-plane scenarios replay bit for bit from the seed,
and since the port's Raft core and LocalBus are the JAX package's, their
``fault_schedule`` and ``state_digest`` equal the JAX package's at the same
seed, and a second port run's.  The daemon-plane scenarios and the
streamed, dispatcher and CDC ones keep their outcome contract in both
packages, with the digest each one's docstring promises equal across the
packages.  The cases of tests/test_chaos.py's scenario harness,
tests/test_batch_dispatch.py's, tests/test_elastic_regions.py's and
tests/test_mvcc.py's scenario tests run on the port with the same
arguments.  The runner prints one JSON line a scenario and exits 0.
"""

import json
import os
import subprocess
import sys

import pytest

from baikaldb_tpu.chaos import failpoint as jfailpoint
from baikaldb_tpu.chaos.scenarios import run_scenario as jrun
from baikaldb_tpu.utils.flags import set_flag as jset_flag
from baikaldb_tpu_torch.chaos import failpoint
from baikaldb_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario
from baikaldb_tpu_torch.utils.flags import set_flag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_PLANE = ("kill_leader", "partition", "split_chaos", "migrate_chaos", "snapshot_chaos")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """Disarm every failpoint around a test, and put back each package's
    lifetime hit / trip counts: they are process-wide, and other files
    compare the two packages' ``information_schema.failpoints``."""
    counts = []
    for fp, sf in ((failpoint, set_flag), (jfailpoint, jset_flag)):
        fp.clear_all()
        sf("chaos_enable", False)
        counts.append(dict(fp._counts))
    yield
    for (fp, sf), kept in zip(((failpoint, set_flag), (jfailpoint, jset_flag)), counts):
        fp.clear_all()
        fp._counts.clear()
        fp._counts.update(kept)
        sf("chaos_enable", False)
        sf("chaos_seed", 0)


def trun(name, seed, **kw):
    return run_scenario(name, seed, device="cpu", **kw)


def test_every_scenario_is_listed():
    from baikaldb_tpu.chaos.scenarios import SCENARIOS as JSCENARIOS

    assert list(SCENARIOS) == list(JSCENARIOS) and len(SCENARIOS) == 10


@pytest.mark.parametrize("name", FLEET_PLANE)
def test_fleet_plane_replays_the_jax_schedule(name):
    """Same seed: the JAX package's fault schedule and state digest, and a
    second port run's."""
    a = trun(name, 4)
    assert a["ok"], a
    b = trun(name, 4)
    w = jrun(name, 4)
    assert w["ok"], w
    assert a["fault_schedule"] == b["fault_schedule"] == w["fault_schedule"]
    assert a["state_digest"] == b["state_digest"] == w["state_digest"]
    assert a["faults"] == w["faults"] > 0


@pytest.mark.parametrize("name", ["rpc_chaos", "dispatch_overload", "fragment_chaos",
                                  "stream_chaos", "cdc_chaos"])
def test_outcome_contract_holds_in_both_packages(name):
    """Thread and socket timing own these interleavings: each package keeps
    the outcome contract, and the row-state digest (a pure function of the
    seed) is equal across the packages."""
    a = trun(name, 5)
    w = jrun(name, 5)
    assert a["ok"], a
    assert w["ok"], w
    assert a["state_digest"] == w["state_digest"]
    if name in ("stream_chaos", "cdc_chaos"):
        # the streamed folds and the CDC schedule are pure functions of the
        # seed too
        assert a["fault_schedule"] == w["fault_schedule"]


# -- tests/test_chaos.py's scenario harness --------------------------------

def test_kill_leader_scenario_deterministic():
    a = trun("kill_leader", 11, writes=14)
    b = trun("kill_leader", 11, writes=14)
    assert a["ok"] and b["ok"], (a, b)
    assert a["fault_schedule"] == b["fault_schedule"]
    assert a["state_digest"] == b["state_digest"]
    assert a["faults"] > 0
    c = trun("kill_leader", 12, writes=14)
    assert c["ok"] and c["fault_schedule"] != a["fault_schedule"]


def test_partition_scenario_converges():
    a = trun("partition", 7, writes=12)
    assert a["ok"], a
    assert a["faults"] > 0
    assert trun("partition", 7, writes=12)["state_digest"] == a["state_digest"]


def test_rpc_chaos_scenario_exactly_once():
    r = trun("rpc_chaos", 21, writes=12, drop_pct=30, delay_pct=25, delay_ms=5)
    assert r["ok"], r
    assert r["faults"] >= 1                     # the leader daemon crashed
    assert r["rpc_retries"] > 0                 # drops forced resends
    assert r["p99_ms"] > 0


def test_stream_chaos_scenario_exactly_once():
    a = trun("stream_chaos", 9, rows=256, chunk_rows=64)
    assert a["ok"], a
    assert a["chunks"] == 4
    assert a["faults"] >= 3
    hard = next(e for e in a["fault_schedule"] if e[0] == "hard_drop")
    assert hard[3] >= 2
    b = trun("stream_chaos", 9, rows=256, chunk_rows=64)
    assert b["ok"] and b["state_digest"] == a["state_digest"]
    assert jrun("stream_chaos", 9, rows=256, chunk_rows=64)["state_digest"] == \
        a["state_digest"]


def test_cdc_chaos_scenario_exactly_once():
    a = trun("cdc_chaos", 9, writes=36)
    assert a["ok"], a
    assert a["redeliveries"] > 0
    assert a["deltas_folded"] > 0
    assert a["events_applied"] > 0
    b = trun("cdc_chaos", 9, writes=36)
    assert b["ok"] and b["state_digest"] == a["state_digest"]
    w = jrun("cdc_chaos", 9, writes=36)
    assert (w["state_digest"], w["redeliveries"], w["deltas_folded"]) == \
        (a["state_digest"], a["redeliveries"], a["deltas_folded"])


# -- the other packages' scenario tests --------------------------------------

def test_chaos_scenario_dispatch_overload():
    out = trun("dispatch_overload", 3, clients=8, queries=6)
    assert out["ok"], out
    assert out["succeeded"] + out["rejected"] == out["queries"]
    assert out["max_queue_depth"] <= 4
    again = trun("dispatch_overload", 3, clients=8, queries=6)
    assert again["state_digest"] == out["state_digest"]


@pytest.mark.parametrize("name,seeds,writes", [
    ("split_chaos", (11, 13), 24), ("migrate_chaos", (11, 12), 20)])
def test_elastic_region_scenarios_deterministic(name, seeds, writes):
    a = trun(name, seeds[0], writes=writes)
    b = trun(name, seeds[0], writes=writes)
    assert a["ok"] and b["ok"], (a, b)
    assert a["fault_schedule"] == b["fault_schedule"]
    assert a["state_digest"] == b["state_digest"]
    if name == "split_chaos":
        assert a["regions"] >= 2
    c = trun(name, seeds[1], writes=writes)
    assert c["ok"], c


def test_snapshot_chaos_scenario_deterministic():
    a = trun("snapshot_chaos", 5, writes=24)
    assert a["ok"], a
    b = trun("snapshot_chaos", 5, writes=24)
    assert b["ok"] and b["state_digest"] == a["state_digest"]
    assert b["fault_schedule"] == a["fault_schedule"]


def test_fragment_chaos_scenario_retargets_and_falls_back():
    a = trun("fragment_chaos", 8)
    assert a["ok"], a
    tags = [e[0] for e in a["fault_schedule"]]
    assert tags[0] == "clean" and "split_retarget" in tags
    assert a["retargets"] >= 1 and a["fallbacks"] >= 1


# -- the runner ----------------------------------------------------------------

def test_chaos_runner_prints_ten_lines_and_exits_zero():
    r = subprocess.run([sys.executable, "-m", "baikaldb_tpu_torch.tools.chaos_run",
                        "--seed", "3", "--device", "cpu"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert sorted(x["scenario"] for x in lines) == sorted(SCENARIOS)
    assert all(x["ok"] and x["seed"] == 3 for x in lines)


def test_scenarios_need_a_card_or_cpu():
    """Without ``device`` a scenario's engine runs on the card: with none
    here, a scenario that builds a Database reports the missing card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_scenario("kill_leader", 1, writes=2)
    assert not out["ok"] and "CUDA" in out["error"]
