"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "baikaldb_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "baikaldb_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_runs_a_query_without_jax():
    code = (
        "import sys, pyarrow as pa\n"
        "from baikaldb_tpu_torch.exec.session import Session\n"
        "s = Session(device='cpu')\n"
        "s.execute('CREATE TABLE t (g INT, v FLOAT)')\n"
        "s.load_arrow('t', pa.table({'g': pa.array(list(range(700)) * 2, pa.int32()),"
        " 'v': pa.array([1.5] * 1400, pa.float32())}))\n"
        "r = s.query('SELECT g, COUNT(*) n, SUM(v) s FROM t WHERE v > 1 GROUP BY g "
        "ORDER BY g LIMIT 3')\n"
        "assert r == [{'g': i, 'n': 2, 's': 3.0} for i in range(3)], r\n"
        "assert 'jax' not in sys.modules and 'baikaldb_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_default_session_needs_cuda():
    from baikaldb_tpu_torch.exec.session import Session

    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Session()


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On a CUDA tensor the entry points launch the kernel or raise: with no
    CUDA build available here, the call must fail, not fall back."""
    from baikaldb_tpu_torch.ops import group_kernels as gk

    def boom():
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(gk, "_library", boom)
    monkeypatch.setattr(gk, "filtered_group_sum_plain",
                        lambda *a: pytest.fail("plain version on a CUDA tensor"))
    meta = torch.device("meta")
    codes = torch.zeros(8, dtype=torch.int32, device=meta)
    # a non-CPU, non-CUDA device is refused before any launch
    with pytest.raises(ValueError, match="unsupported device"):
        gk.filtered_group_sum(codes, codes.float(), codes.bool(), 4)
    monkeypatch.setattr(gk, "_check", lambda *a: None)
    with pytest.raises(RuntimeError, match="no kernel library"):
        gk.filtered_group_sum(codes, codes.float(), codes.bool(), 4)


NETWORK_PLANE = ("baikaldb_tpu_torch.server.store_server", "baikaldb_tpu_torch.server.meta_server",
                 "baikaldb_tpu_torch.tools.deploy_cluster", "baikaldb_tpu_torch.utils.net",
                 "baikaldb_tpu_torch.storage.remote_tier",
                 "baikaldb_tpu_torch.storage.binlog_regions",
                 "baikaldb_tpu_torch.plan.fragment", "baikaldb_tpu_torch.exec.fragments")


def test_network_plane_and_daemons_import_without_jax():
    """The daemons (server/), the cluster deploy tool (tools/) and the
    network plane they share import neither JAX nor the JAX package, and
    touch no card at import; the daemons' modules import no torch at all
    (the package's ``ColumnBatch`` loads at first use)."""
    code = ("import sys, importlib\n"
            f"for m in {NETWORK_PLANE!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules and 'baikaldb_tpu' not in sys.modules\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    daemons = ("import sys\n"
               "import baikaldb_tpu_torch.server.store_server\n"
               "import baikaldb_tpu_torch.server.meta_server\n"
               "assert 'torch' not in sys.modules, 'a daemon imports torch'\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    r = subprocess.run([sys.executable, "-c", daemons], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_spawned_daemons_see_no_card():
    """``spawn_cluster`` starts its daemons with ``CUDA_VISIBLE_DEVICES``
    empty, from the checkout's root; its MySQL frontends keep the caller's
    view of the card and run on it unless given a device: with no card
    here, a frontend without ``device`` refuses to start (no fall-back to
    the CPU)."""
    import socket

    from baikaldb_tpu_torch.tools import deploy_cluster

    assert deploy_cluster._ENV["CUDA_VISIBLE_DEVICES"] == ""
    assert deploy_cluster._FRONTEND_ENV.get("CUDA_VISIBLE_DEVICES") == \
        os.environ.get("CUDA_VISIBLE_DEVICES")
    assert deploy_cluster._repo_root() == ROOT
    if torch.cuda.is_available():
        return
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    _, procs = deploy_cluster.spawn_cluster(1, 0, mysql_port=port)
    try:
        with pytest.raises(TimeoutError, match="CUDA"):
            deploy_cluster.wait_frontends(procs, timeout=120.0)
    finally:
        deploy_cluster.teardown(procs)
