"""The system under test: baikaldb_tpu_torch, and the only module of the
harness that imports it.  It builds the port's kernels, loads the generated
tables into one ``Database`` on the device, hands out ``Session``s, and
reads the program's own spans (``obs/trace.py``) and counters
(``utils/metrics.py``) around the window."""

from __future__ import annotations

import gc
import threading

import torch

# tracing flags of a traced run: every statement's trace kept
TRACE_FLAGS = {"tracing": 1, "trace_sample_n": 1, "trace_store_max": 10_000_000}


class Program:
    def __init__(self, device: str, config: dict, trace: bool):
        from baikaldb_tpu_torch.exec.session import Database, Session

        self._Session = Session
        self.device = device
        self.db = Database(device)
        self.admin = Session(self.db)
        flags = dict(config.get("flags", {}))
        if trace:
            flags.update(TRACE_FLAGS)
        for k, v in flags.items():
            self.admin.execute(f"SET GLOBAL {k} = {v}")
        self._marks: dict = {}

    @staticmethod
    def build_kernels(device: str) -> threading.Thread | None:
        """Start the build of the port's CUDA sources (a no-op once the
        checkout's build directory holds them) on a thread; the caller joins
        it before the first statement."""
        if device != "cuda":
            return None
        from baikaldb_tpu_torch.ops import group_kernels

        err: list = []

        def build():
            try:
                group_kernels.build_all()
            except BaseException as e:      # noqa: BLE001 — re-raised by join()
                err.append(e)

        t = threading.Thread(target=build, name="gpubench-build")
        t.err = err
        t.start()
        return t

    def load(self, config: dict, tables: dict) -> None:
        """CREATE each table, load its rows and stage it on the device."""
        for name, ddl in config["tables"].items():
            self.admin.execute(ddl)
            self.admin.load_arrow(name, tables[name])
        for store in self.db.stores.values():
            store.device_table_batch()
        if self.device == "cuda":
            torch.cuda.synchronize()

    def session(self):
        return self._Session(self.db)

    def window_begin(self) -> None:
        """Counters and kept traces start from nothing at the window."""
        from baikaldb_tpu_torch.obs import trace
        from baikaldb_tpu_torch.utils import metrics

        self._marks = {}
        for inst in _instruments(metrics):
            if isinstance(inst, metrics.LatencyRecorder):
                inst.reset()
            elif isinstance(inst, metrics.Counter):
                self._marks[inst.name] = inst.value
        trace.TRACER.clear()

    def window_end(self) -> tuple[dict, list]:
        """-> ({counter: its count over the window, recorder: its stats
        over the window}, the kept traces)."""
        from baikaldb_tpu_torch.obs import trace
        from baikaldb_tpu_torch.utils import metrics

        counters = {}
        for inst in _instruments(metrics):
            if isinstance(inst, metrics.LatencyRecorder):
                counters[inst.name] = inst.stats()
            elif isinstance(inst, metrics.Counter):
                counters[inst.name] = inst.value - self._marks.get(inst.name, 0)
        return counters, trace.TRACER.list()

    def close(self) -> None:
        """Stop the Database's threads and let go of every tensor it holds."""
        from baikaldb_tpu_torch.obs import trace

        trace.TRACER.clear()
        self.db.close()
        self.db = self.admin = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _instruments(metrics) -> list:
    """Every plain counter and latency recorder of the program's registry
    (the registry keeps no public list of its instruments)."""
    return [metrics.REGISTRY.get(name) for name in metrics.REGISTRY.expose()]
