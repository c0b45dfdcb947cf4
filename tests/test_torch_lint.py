"""The port's lint (baikaldb_tpu_torch/analysis/) held against the JAX
package's (baikaldb_tpu/analysis/), on their outputs.

- Every JAX fixture of a backend-independent rule in tests/test_lint.py
  (read from that file, unchanged) goes through both linters: the same
  (rule, line, function) list, and the list tests/test_lint.py pins.
- HOSTSYNC on paired fixtures: the JAX fixture's ``jnp`` spelling through
  the JAX linter, the same source with ``import torch as jnp`` through the
  port's, at the same lines.  The JAX RETRACE sinks of a branch or a loop
  over a device value are HOSTSYNC in the port (eager torch reads the value
  back; there is no trace to retrace).
- The whole ``baikaldb_tpu/`` tree, with the JAX config and registry and
  the backend-independent rules: the same violations (none), the same
  derived lock order and the same ownership map.
- The port's own tree: clean against its registry, every registry entry
  commented, the declared ranks consistent with the static lock graph and
  with the README's table, the dispatcher's ownership map pinned.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from baikaldb_tpu.analysis import LintConfig as JConfig  # noqa: E402
from baikaldb_tpu.analysis import run_lint as jrun_lint  # noqa: E402
from baikaldb_tpu_torch.analysis import LintConfig, run_lint  # noqa: E402
from baikaldb_tpu_torch.analysis.lint import RULES, _FuncIndex  # noqa: E402

# the rules whose logic does not depend on the backend
SHARED = ("LOCKORDER", "BAREEXC", "FAILPOINTHOT", "GUARDEDBY",
          "LOCKHELDBLOCK", "ATOMICITY")
PORT_REGISTRY = os.path.join(REPO, "baikaldb_tpu_torch", "tools",
                             "lint_suppressions.txt")
JAX_REGISTRY = os.path.join(REPO, "tools", "tpulint_suppressions.txt")
FIXTURE_REL = "baikaldb_tpu/ops/fixture.py"


def _jax_fixtures() -> dict:
    """name -> (source, rel, suppression text or None, pinned list) of the
    single-fixture tests in tests/test_lint.py."""
    path = os.path.join(REPO, "tests", "test_lint.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        src = rel = sup = want = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "lint_src":
                arg = node.args[1]
                if isinstance(arg, ast.Name):       # src = """..."""; lint_src(tmp, src)
                    arg = next(a.value for a in ast.walk(fn)
                               if isinstance(a, ast.Assign)
                               and a.targets[0].id == arg.id)
                src = arg.value
                rel = next((k.value.value for k in node.keywords if k.arg == "rel"),
                           FIXTURE_REL)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "write_text" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                sup = node.args[0].value
            elif isinstance(node, ast.Assert) and isinstance(node.test, ast.Compare) \
                    and isinstance(node.test.left, ast.Name) and node.test.left.id == "out":
                want = ast.literal_eval(node.test.comparators[0])
        if src is not None:
            out[fn.name] = (src, rel, sup, want)
    return out


JAX_FIXTURES = _jax_fixtures()

SHARED_FIXTURES = [
    "test_lockorder_cycle", "test_lockorder_consistent_order_clean",
    "test_lockorder_sync_under_lock", "test_bareexc",
    "test_failpointhot_unguarded_site", "test_failpointhot_guarded_sites_clean",
    "test_failpointhot_in_traced_scope", "test_failpointhot_jit_decorated",
    "test_failpointhot_guard_outside_def_does_not_count",
    "test_guardedby_unguarded_read_and_write", "test_guardedby_swap_publish_read_clean",
    "test_lockheldblock_sleep_under_lock", "test_lockheldblock_snapshot_then_sleep_clean",
    "test_atomicity_check_then_act", "test_atomicity_lock_around_check_and_act_clean",
    "test_inline_suppression", "test_suppression_file_by_qualname",
]
HOSTSYNC_PAIRS = [
    "test_hostsync_int_on_device", "test_hostsync_item_and_np",
    "test_hostsync_clean_counterpart", "test_param_feed_fixture_hostsync_flagged",
    "test_visibility_mask_fixture_hostsync_flagged", "test_retrace_branch_on_traced",
    "test_retrace_loop_over_device_array",
]


def _torch_spelling(src: str) -> str:
    """The JAX fixture with the port's array library: same lines."""
    return src.replace("import jax.numpy as jnp", "import torch as jnp")


def _lint(tmp_path, which: str, src: str, rel: str = FIXTURE_REL, sup: str | None = None,
          rules=RULES, package: str = "baikaldb_tpu") -> list:
    """Lint ``src`` at ``rel`` with one package's linter -> [(rule, line,
    enclosing function)]."""
    root = tmp_path / which
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    text = textwrap.dedent(src)
    path.write_text(text)
    sup_path = None
    if sup is not None:
        sup_path = root / "sup.txt"
        sup_path.write_text(sup)
    if which == "jax":
        cfg = JConfig(suppression_file=sup_path and str(sup_path), rules=rules)
        vs = jrun_lint([str(path)], cfg, root=str(root))
    else:
        cfg = LintConfig(suppression_file=sup_path and str(sup_path), rules=rules,
                         package=package)
        vs = run_lint([str(path)], cfg, root=str(root))
    fi = _FuncIndex(ast.parse(text))
    return sorted((v.rule, v.line, fi.at(v.line)) for v in vs)


# ---- 1. fixture parity on the backend-independent rules --------------------

@pytest.mark.parametrize("name", SHARED_FIXTURES)
def test_shared_rule_fixtures_match_jax(tmp_path, name):
    src, rel, sup, want = JAX_FIXTURES[name]
    rules = SHARED + ("HOSTSYNC",)
    jax_out = _lint(tmp_path, "jax", src, rel, sup, rules)
    port_out = _lint(tmp_path, "port", _torch_spelling(src), rel, sup, rules)
    assert port_out == jax_out
    # and the list tests/test_lint.py pins (the cycle test pins membership)
    got = sorted((r, ln) for r, ln, _ in port_out)
    if name == "test_lockorder_cycle":
        assert ("LOCKORDER", 12) in got
    else:
        assert got == sorted(want), (name, got, want)


# ---- 2. HOSTSYNC on paired fixtures -----------------------------------------

@pytest.mark.parametrize("name", HOSTSYNC_PAIRS)
def test_hostsync_pairs_match_jax(tmp_path, name):
    src, rel, sup, _ = JAX_FIXTURES[name]
    jax_out = _lint(tmp_path, "jax", src, rel, sup, ("HOSTSYNC", "RETRACE"))
    port_out = _lint(tmp_path, "port", _torch_spelling(src), rel, sup, ("HOSTSYNC",))
    assert port_out == sorted(("HOSTSYNC", ln, f) for _, ln, f in jax_out)


TORCH_ONLY = {
    # .cpu() / .tolist() / .numpy() read the tensor back
    "cpu_tolist_numpy": ("""\
        import torch
        def f(x):
            y = torch.abs(x)
            a = y.cpu()
            b = y.tolist()
            return a, b, y.numpy()
        """, FIXTURE_REL, [4, 5, 6]),
    # a boolean mask and nonzero in a hot module: data-dependent shapes
    "mask_in_hot_module": ("""\
        import torch
        def f(x: torch.Tensor):
            m = x > 0
            a = x[m]
            return a, torch.nonzero(m)
        """, FIXTURE_REL, [4, 5]),
    # the same in a host module: no host read on its own
    "mask_in_host_module": ("""\
        import torch
        def f(x: torch.Tensor):
            m = x > 0
            a = x[m]
            return a, torch.nonzero(m)
        """, "baikaldb_tpu/server/fixture.py", []),
    # the sanctioned spelling and host metadata stay quiet (the shape of
    # ops/hashagg.py's `if v.numel() == 0`)
    "host_read_and_metadata": ("""\
        import torch
        from baikaldb_tpu_torch.analysis.runtime import host_read
        def f(x, v: torch.Tensor):
            if v.numel() == 0 or v.dim() > 1 or x.shape[0] == 0:
                return None
            n = int(host_read(torch.sum(x)))
            idx = host_read(x > 0, torch.nonzero)
            return n, idx, len(v), v.dtype, v.device
        """, FIXTURE_REL, []),
    # a tensor-typed parameter taints; a branch on it reads it back
    "annotated_param_branch": ("""\
        import torch
        def f(v: torch.Tensor):
            if v.any():
                return 1
            return 0 if not v.all() else 2
        """, "baikaldb_tpu/server/fixture.py", [3, 5]),
}


@pytest.mark.parametrize("name", sorted(TORCH_ONLY))
def test_torch_only_sinks(tmp_path, name):
    src, rel, lines = TORCH_ONLY[name]
    out = _lint(tmp_path, "port", src, rel, rules=("HOSTSYNC",))
    assert [ln for _, ln, _ in out] == lines, out


# ---- 3. the whole JAX tree through both linters ---------------------------

@pytest.fixture(scope="module")
def jax_tree_runs():
    """One run per package over baikaldb_tpu/, JAX config and registry,
    backend-independent rules (about 10 s each on a CPU)."""
    pkg = os.path.join(REPO, "baikaldb_tpu")
    jv = jrun_lint([pkg], JConfig(suppression_file=JAX_REGISTRY, rules=SHARED), root=REPO)
    jax_side = (jv, list(jrun_lint.last_lock_order), dict(jrun_lint.last_ownership))
    tv = run_lint([pkg], LintConfig(package="baikaldb_tpu", suppression_file=JAX_REGISTRY,
                                    rules=SHARED), root=REPO)
    port_side = (tv, list(run_lint.last_lock_order), dict(run_lint.last_ownership))
    return jax_side, port_side


def test_jax_tree_violations_match(jax_tree_runs):
    (jv, _, _), (tv, _, _) = jax_tree_runs
    assert [v.render() for v in tv] == [v.render() for v in jv] == []


def test_jax_tree_lock_order_matches(jax_tree_runs):
    (_, jorder, _), (_, torder, _) = jax_tree_runs
    assert jorder and torder == jorder


def test_jax_tree_ownership_matches(jax_tree_runs):
    from baikaldb_tpu.analysis.ownership import package_ownership as jown
    from baikaldb_tpu_torch.analysis.ownership import package_ownership

    (_, _, jmap), (_, _, tmap) = jax_tree_runs
    assert tmap == jmap
    assert package_ownership(pkg_dir=os.path.join(REPO, "baikaldb_tpu")) == jown()


# ---- 4. the port's own tree ---------------------------------------------

@pytest.fixture(scope="module")
def port_tree_run():
    cfg = LintConfig(suppression_file=PORT_REGISTRY)
    vs = run_lint([os.path.join(REPO, "baikaldb_tpu_torch")], cfg, root=REPO)
    return vs, list(run_lint.last_lock_edges), dict(run_lint.last_ownership)


def test_port_tree_is_clean(port_tree_run):
    vs = port_tree_run[0]
    assert vs == [], "lint violations crept in:\n" + "\n".join(v.render() for v in vs)


def test_registry_entries_are_commented():
    """Every entry of the port's registry sits in a block that a comment
    saying why opens, and names a file of the port."""
    text = open(PORT_REGISTRY, encoding="utf-8").read()
    n = 0
    for block in re.split(r"\n\s*\n", text):
        lines = [ln.strip() for ln in block.strip().splitlines()]
        entries = [ln for ln in lines if ln and not ln.startswith("#")]
        if entries:
            assert lines[0].startswith("#"), f"uncommented registry entries: {entries}"
        for e in entries:
            path = e.split()[0]
            assert path.startswith("baikaldb_tpu_torch/"), e
            assert os.path.exists(os.path.join(REPO, path)), e
            n += 1
    assert n >= 10


def test_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "baikaldb_tpu_torch.tools.lint"]
    r = subprocess.run(cmd + [os.path.join(REPO, "baikaldb_tpu_torch")], cwd=REPO,
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout
    bad = tmp_path / "baikaldb_tpu_torch" / "ops" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n"
                   "def f(x):\n"
                   "    return int(torch.sum(x))\n")
    r = subprocess.run(cmd + ["--json", str(bad)], cwd=REPO, capture_output=True,
                       text=True, env=env)
    assert r.returncode == 1
    assert '"HOSTSYNC"' in r.stdout and '"total": 1' in r.stdout
    r = subprocess.run(cmd + ["--rules", "RETRACE", str(bad)], cwd=REPO,
                       capture_output=True, text=True, env=env)
    assert r.returncode == 2
    r = subprocess.run(cmd + ["--list-rules"], cwd=REPO, capture_output=True, text=True,
                       env=env)
    assert r.returncode == 0 and [ln.split()[0] for ln in r.stdout.splitlines()] == list(RULES)


# static lock ids of the port -> runtime GuardedLock names
_STATIC_TO_RUNTIME = {
    "baikaldb_tpu_torch/exec/session.py:_TableBinlogRetry.mu": "db.binlog_retry_mu",
    "baikaldb_tpu_torch/storage/column_store.py:TableStore._lock": "store.table_lock",
    "baikaldb_tpu_torch/storage/replicated.py:ReplicatedRowTier._mu": "replicated.tier_mu",
    "baikaldb_tpu_torch/storage/mvcc.py:SnapshotRegistry._mu": "mvcc.registry_mu",
    "baikaldb_tpu_torch/storage/mvcc.py:TsoClient._mu": "mvcc.tso_mu",
    "baikaldb_tpu_torch/exec/dispatch.py:BatchDispatcher._mu": "dispatch.combine_mu",
    "baikaldb_tpu_torch/exec/dispatch.py:BatchDispatcher._tick_mu": "dispatch.tick_mu",
    "baikaldb_tpu_torch/obs/telemetry.py:Telemetry._mu": "telemetry.scrape_mu",
    "baikaldb_tpu_torch/obs/watchdog.py:Watchdog._mu": "watchdog.scan_mu",
}


def _port_ranks() -> dict:
    # importing the owning modules registers every production rank
    import baikaldb_tpu_torch.exec.dispatch  # noqa: F401
    import baikaldb_tpu_torch.exec.session  # noqa: F401
    import baikaldb_tpu_torch.obs.telemetry  # noqa: F401
    import baikaldb_tpu_torch.obs.watchdog  # noqa: F401
    import baikaldb_tpu_torch.storage.column_store  # noqa: F401
    import baikaldb_tpu_torch.storage.mvcc  # noqa: F401
    import baikaldb_tpu_torch.storage.replicated  # noqa: F401
    from baikaldb_tpu_torch.analysis.runtime import LOCK_RANKS

    return LOCK_RANKS


def test_declared_ranks_match_static_graph(port_tree_run):
    """Every static acquisition edge A->B between ranked locks satisfies
    rank[A] < rank[B], and the JAX package's eight names carry its ranks."""
    ranks = _port_ranks()
    edges = port_tree_run[1]
    checked = 0
    for a, b in edges:
        ra = ranks.get(_STATIC_TO_RUNTIME.get(a, ""))
        rb = ranks.get(_STATIC_TO_RUNTIME.get(b, ""))
        if ra is not None and rb is not None:
            assert ra < rb, f"declared ranks contradict static edge {a}->{b}"
            checked += 1
    assert checked >= 4, "too few ranked edges were cross-checked"
    from baikaldb_tpu.analysis.runtime import LOCK_RANKS as JRANKS
    import baikaldb_tpu.exec.dispatch  # noqa: F401
    import baikaldb_tpu.exec.session  # noqa: F401
    import baikaldb_tpu.obs.telemetry  # noqa: F401
    import baikaldb_tpu.obs.watchdog  # noqa: F401
    import baikaldb_tpu.storage.column_store  # noqa: F401
    import baikaldb_tpu.storage.mvcc  # noqa: F401
    import baikaldb_tpu.storage.replicated  # noqa: F401
    shared = ("dispatch.combine_mu", "telemetry.scrape_mu", "watchdog.scan_mu",
              "store.table_lock", "mvcc.registry_mu", "mvcc.tso_mu",
              "db.binlog_retry_mu", "replicated.tier_mu")
    assert {n: ranks[n] for n in shared} == {n: JRANKS[n] for n in shared}


def test_readme_rank_table_matches_registry():
    """README's rank table of the port is the documentation of record: its
    rows equal LOCK_RANKS, and every GuardedLock in the port's source is in
    it."""
    ranks = _port_ranks()
    rows: dict[str, int] = {}
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    section = text[text.index("<!-- port-lock-ranks -->"):]
    section = section[:section.index("<!-- /port-lock-ranks -->")]
    for line in section.splitlines():
        m = re.match(r"\|\s*`([a-z_.]+)`\s*\|\s*(\d+)\s*\|", line.strip())
        if m:
            rows[m.group(1)] = int(m.group(2))
    src_names: set[str] = set()
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, "baikaldb_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    src_names.update(re.findall(r'GuardedLock\(\s*"([^"]+)"', f.read()))
    assert rows and src_names == set(rows)
    assert rows == {n: ranks[n] for n in rows}


def test_static_ownership_matches_runtime_witness(port_tree_run):
    """The witness arms exactly the exported static ownership of the
    port's BatchDispatcher, pinned to its inferred content."""
    from baikaldb_tpu_torch.analysis.ownership import package_ownership
    from baikaldb_tpu_torch.analysis.runtime import witness_stats
    import baikaldb_tpu_torch.exec.dispatch  # noqa: F401 — enrolls the class

    sid = "baikaldb_tpu_torch/exec/dispatch.py:BatchDispatcher"
    own = package_ownership()
    assert own[sid] == {"_groups": "_mu", "_inflight": "_mu", "occupancy": "_mu",
                        "_programs": "_mu"}
    assert witness_stats()["classes"][sid] == sorted(own[sid])
    assert port_tree_run[2][sid] == own[sid]
    for cls in ("obs/telemetry.py:Telemetry", "obs/watchdog.py:Watchdog"):
        assert witness_stats()["classes"]["baikaldb_tpu_torch/" + cls]
