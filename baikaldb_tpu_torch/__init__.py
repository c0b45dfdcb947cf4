"""baikaldb_tpu_torch — the PyTorch/CUDA port of baikaldb_tpu.

The same query engine (SQL -> planner -> columnar operators) on torch
tensors, with the JAX package's Pallas kernels rewritten as hand-written
CUDA kernels for Hopper (ops/csrc/).  The layout mirrors ``baikaldb_tpu``
module for module; the JAX package stays the reference the port is tested
against.  Entry point: ``baikaldb_tpu_torch.exec.session.Session``, which
runs on CUDA unless the caller passes ``device="cpu"``.

``Column`` / ``ColumnBatch`` load with their module at first use: the
store and meta daemons (server/) import this package and never touch
torch.
"""

from .types import Field, LType, Schema  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name: str):
    if name in ("Column", "ColumnBatch"):
        from .column import batch

        return getattr(batch, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
