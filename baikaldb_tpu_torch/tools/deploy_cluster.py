"""Mini-cluster deploy: 1 meta + N store daemons + MySQL frontends, all real
processes on one host (the reference deployment shape, sysbench/
baikaldb_deploy_scripts/init.sh: baikalMeta + 3 baikalStore + baikaldb).

The port of ``baikaldb_tpu/tools/deploy_cluster.py``.  The daemons are
host-only: they are spawned with ``CUDA_VISIBLE_DEVICES`` empty, so none of
them opens a CUDA context, and the native libraries they load (the row
engine and the Raft core) are built here, in the parent, before the first
spawn.  A MySQL frontend (``python -m baikaldb_tpu_torch.server --meta
...``) is the engine: it keeps the caller's view of the card and runs on
``device`` (the card unless the caller names another, as the CPU tests
do).  ``mysql_port`` 0 spawns no frontend (the caller's own
``Session(Database(device, cluster=meta_address))`` is one).

``base_port=0`` lets every daemon bind a free port and report it back (its
``... serving on host:port`` line), so several clusters run side by side.
``cold_dir`` is one directory shared by the daemons and the frontends (the
external filesystem the cold segments live on), so a daemon folds the
segments a frontend flushed in place; ``aot_dir`` gets one subdirectory a
store (each daemon's fragment-body blobs).

Usage:
    python -m baikaldb_tpu_torch.tools.deploy_cluster [--stores 3] \\
        [--base-port 9100] [--mysql-port 28000] [--frontends 1] \\
        [--device cpu] [--cold-dir D] [--aot-dir D]

Prints one line per process and stays in the foreground; Ctrl-C tears the
cluster down.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from ..utils.net import RpcClient

_ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
_FRONTEND_ENV = dict(os.environ, PYTHONPATH="")     # the card stays visible
_SERVING = re.compile(rb"serving on (\S+:\d+)")
_LISTENING = re.compile(rb"listening on (\S+):(\d+)")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def build_native() -> None:
    """Build the row engine and the Raft core once, in this process, so
    the daemons only load them (concurrent first builds race)."""
    from ..native import require
    from ..raft.core import raft_available

    require()
    if not raft_available():
        raise RuntimeError("the native raft core does not build")


def _spawn(args: list[str], log_dir: str,
           env: dict = _ENV) -> tuple[subprocess.Popen, str]:
    name = args[0].rsplit(".", 1)[-1] + "_" + \
        "_".join(a.replace(":", "_").replace("/", "_")
                 for a in args[1:] if not a.startswith("--"))
    path = os.path.join(log_dir, name + ".log")
    with open(path, "ab") as out:
        proc = subprocess.Popen([sys.executable, "-m"] + args, env=env,
                                cwd=_repo_root(), stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, path


def _wait_serving(proc: subprocess.Popen, log: str, address: str,
                  timeout: float = 60.0) -> str:
    """The daemon's address once it answers ``ping``; a port-0 address is
    read from the daemon's ``serving on`` line."""
    deadline = time.monotonic() + timeout
    while address.endswith(":0"):
        with open(log, "rb") as f:
            m = _SERVING.search(f.read())
        if m:
            address = m.group(1).decode()
            break
        if proc.poll() is not None or time.monotonic() > deadline:
            raise TimeoutError(f"daemon {proc.args[2:]} did not start "
                               f"(exit {proc.poll()}, log {log})")
        time.sleep(0.1)
    client = RpcClient(address, timeout=1.0)
    while time.monotonic() < deadline:
        if client.try_call("ping") is not None:
            client.close()
            return address
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    raise TimeoutError(f"no ping from {address} (log {log})")


def _wait_listening(proc: subprocess.Popen, log: str,
                    timeout: float = 180.0) -> int:
    """A frontend's port once its ``listening on`` line is out (the engine
    imported and the listener bound)."""
    deadline = time.monotonic() + timeout
    while True:
        with open(log, "rb") as f:
            m = _LISTENING.search(f.read())
        if m:
            return int(m.group(2))
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(log, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise TimeoutError(f"frontend {proc.args[2:]} did not start "
                               f"(exit {proc.poll()}, log {log}): {tail}")
        time.sleep(0.1)


def spawn_cluster(n_stores: int = 3, base_port: int = 0,
                  mysql_port: int = 0, n_mysql: int = 1,
                  aot_dir: str = "", cold_dir: str = "", device=None):
    """-> (meta_address, {"meta", "stores", "store_addresses", "mysql",
    "mysqls", "mysql_ports", "mysql_logs", "log_dir", "own_log_dir"}).
    ``base_port`` 0 binds free ports; else the meta daemon takes
    ``base_port`` and store i ``base_port + i``.  ``mysql_port`` > 0 spawns
    ``n_mysql`` frontends on consecutive ports from it, each over the
    cluster, on ``device`` (None: the card).  Returns once the daemons
    answer; the frontends import the engine meanwhile, and
    ``wait_frontends`` waits until each listens.  Process output goes to
    ``BK_CLUSTER_LOGS`` if set, else to a fresh temporary directory that
    ``teardown`` removes."""
    build_native()
    log_dir = os.environ.get("BK_CLUSTER_LOGS")
    own_logs = not log_dir
    if own_logs:
        log_dir = tempfile.mkdtemp(prefix="bk_cluster_")
    os.makedirs(log_dir, exist_ok=True)
    meta_addr = f"127.0.0.1:{base_port}"
    meta, log = _spawn(["baikaldb_tpu_torch.server.meta_server",
                        "--address", meta_addr,
                        "--peer-count", str(n_stores)], log_dir)
    procs = {"meta": meta, "stores": [], "store_addresses": [], "mysql": None,
             "mysqls": [], "mysql_ports": [], "mysql_logs": [], "log_dir": log_dir,
             "own_log_dir": own_logs}
    try:
        meta_addr = _wait_serving(meta, log, meta_addr)
        started = []                    # the stores start side by side
        for i in range(1, n_stores + 1):
            addr = f"127.0.0.1:{base_port + i if base_port else 0}"
            cmd = ["baikaldb_tpu_torch.server.store_server",
                   "--store-id", str(i), "--address", addr,
                   "--meta", meta_addr]
            if aot_dir:
                cmd += ["--aot-dir", os.path.join(aot_dir, f"store{i}")]
            if cold_dir:
                cmd += ["--cold-dir", cold_dir]
            proc, log = _spawn(cmd, log_dir)
            procs["stores"].append(proc)
            started.append((proc, log, addr))
        if mysql_port and n_mysql > 0:     # they start beside the stores
            for j in range(n_mysql):
                cmd = ["baikaldb_tpu_torch.server", "--port", str(mysql_port + j),
                       "--meta", meta_addr]
                if device is not None:
                    cmd += ["--device", str(device)]
                if cold_dir:
                    cmd += ["--cold-dir", cold_dir]
                proc, log = _spawn(cmd, log_dir, _FRONTEND_ENV)
                procs["mysqls"].append(proc)
                procs["mysql_ports"].append(mysql_port + j)
                procs["mysql_logs"].append(log)
            procs["mysql"] = procs["mysqls"][0]
        for proc, log, addr in started:
            procs["store_addresses"].append(_wait_serving(proc, log, addr))
    except BaseException:
        teardown(procs)
        raise
    return meta_addr, procs


def wait_frontends(procs: dict, timeout: float = 180.0) -> list[int]:
    """Wait until every frontend of ``spawn_cluster`` listens -> their
    ports; a frontend that exits first (no card, say) raises with its
    log's tail."""
    return [_wait_listening(p, log, timeout)
            for p, log in zip(procs["mysqls"], procs["mysql_logs"])]


def teardown(procs: dict) -> None:
    victims = procs.get("mysqls", []) + [procs.get("meta")] + procs.get("stores", [])
    for p in victims:
        if p is not None and p.poll() is None:
            p.terminate()
    for p in victims:
        if p is not None:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
    if procs.get("own_log_dir"):
        shutil.rmtree(procs["log_dir"], ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stores", type=int, default=3)
    ap.add_argument("--base-port", type=int, default=9100)
    ap.add_argument("--mysql-port", type=int, default=28000,
                    help="first frontend's port (0: no frontend)")
    ap.add_argument("--frontends", type=int, default=1,
                    help="MySQL frontends on consecutive ports")
    ap.add_argument("--device", default=None,
                    help="the frontends' torch device (default: the CUDA card)")
    ap.add_argument("--aot-dir", default="",
                    help="fragment blob root (per-store subdirs)")
    ap.add_argument("--cold-dir", default="",
                    help="cold-segment FS root, shared by every daemon")
    args = ap.parse_args()
    meta_addr, procs = spawn_cluster(args.stores, args.base_port,
                                     args.mysql_port, n_mysql=args.frontends,
                                     aot_dir=args.aot_dir,
                                     cold_dir=args.cold_dir, device=args.device)
    try:
        wait_frontends(procs)
    except TimeoutError:
        teardown(procs)
        raise
    print(f"meta     @ {meta_addr} (pid {procs['meta'].pid})")
    for i, (p, a) in enumerate(zip(procs["stores"],
                                   procs["store_addresses"]), 1):
        print(f"store {i}  @ {a} (pid {p.pid})")
    for j, (p, port) in enumerate(zip(procs["mysqls"], procs["mysql_ports"])):
        print(f"mysql {j}  @ 127.0.0.1:{port} (pid {p.pid})")
    print("cluster up — Ctrl-C to tear down", flush=True)

    def _stop(signum, frame):
        teardown(procs)
        sys.exit(0)

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
