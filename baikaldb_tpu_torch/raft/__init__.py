"""Raft consensus layer (reference: braft per-Region replication, SURVEY
§2.9).  The consensus core is native C++ (native/raft.cpp — a deterministic
state machine); this package owns what the reference delegates to brpc and
the OS: transport, timers, storage apply, and group management.

The port's copy of ``baikaldb_tpu/raft/``: ``native/raft.cpp`` byte for byte,
built by native/__init__.py ``build_library``."""

from .core import RaftCore, raft_available
from .cluster import LocalBus, RaftGroup, ReplicatedRegion

__all__ = ["RaftCore", "raft_available", "LocalBus", "RaftGroup",
           "ReplicatedRegion"]
