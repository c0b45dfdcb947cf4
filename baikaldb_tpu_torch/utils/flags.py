"""Config/flag system — the gflags analog (SURVEY §5.6).

The reference configures every binary exclusively through gflags: each
process loads ``conf/gflags.conf`` at startup (src/protocol/main.cpp:64,
src/store/main.cpp:83) and the meta service pushes per-instance overrides
through heartbeat responses so flags can be changed cluster-wide at runtime
(update_instance_param, include/meta_server/cluster_manager.h:128,141-143).

Here a single process-wide registry serves the same three channels:

- **definition at point of use**: ``define("qos_rate", 1000.0, "...")`` in
  the module that reads it; reading is ``FLAGS.qos_rate``.
- **startup file / argv**: ``load_file(path)`` parses gflags.conf syntax
  (``--name=value``, ``#`` comments); ``load_args(argv)`` takes the same
  form from a command line.
- **dynamic runtime updates**: ``set_flag(name, value)`` coerces to the
  defined type and fires registered listeners — the meta service piggybacks
  ``{name: value}`` override maps on heartbeat responses and stores apply
  them through this call (tests/test_flags.py drives the loop end-to-end).

Values are typed by their default (bool/int/float/str); ``SHOW VARIABLES``
and information_schema surface the live table.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class _Flag:
    name: str
    default: Any
    help: str
    value: Any
    listeners: list = field(default_factory=list)


class FlagError(ValueError):
    pass


def _coerce(name: str, default: Any, value: Any):
    t = type(default)
    if isinstance(value, t):
        return value
    if t is bool:
        if isinstance(value, int):          # MySQL clients send 0/1
            return bool(value)
        if isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "1", "yes", "on"):
                return True
            if v in ("false", "0", "no", "off"):
                return False
        raise FlagError(f"flag {name}: cannot parse {value!r} as bool")
    try:
        return t(value)
    except (TypeError, ValueError) as e:
        raise FlagError(f"flag {name}: cannot parse {value!r} "
                        f"as {t.__name__}") from e


class FlagRegistry:
    def __init__(self):
        self._flags: dict[str, _Flag] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default: Any, help: str = "") -> None:
        """Register a flag; re-defining with the same default is a no-op
        (modules may be reloaded), a different default is an error."""
        with self._lock:
            f = self._flags.get(name)
            if f is not None:
                if f.default != default:
                    raise FlagError(f"flag {name} already defined with "
                                    f"default {f.default!r}")
                return
            self._flags[name] = _Flag(name, default, help, default)

    def set_flag(self, name: str, value: Any) -> None:
        with self._lock:
            f = self._flags.get(name)
            if f is None:
                raise FlagError(f"unknown flag {name!r}")
            new = _coerce(name, f.default, value)
            if new == f.value:
                return          # idempotent re-delivery: listeners stay quiet
            f.value = new
            listeners = list(f.listeners)
        for cb in listeners:
            cb(new)

    def on_change(self, name: str, cb: Callable[[Any], None]) -> None:
        """Register a callback fired (outside the lock) on every set_flag."""
        with self._lock:
            f = self._flags.get(name)
            if f is None:
                raise FlagError(f"unknown flag {name!r}")
            f.listeners.append(cb)

    def get(self, name: str):
        with self._lock:
            f = self._flags.get(name)
            if f is None:
                raise FlagError(f"unknown flag {name!r}")
            return f.value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {n: f.value for n, f in sorted(self._flags.items())}

    def defaults(self) -> dict[str, Any]:
        with self._lock:
            return {n: f.default for n, f in sorted(self._flags.items())}

    def describe(self) -> list[tuple[str, Any, Any, str]]:
        """(name, value, default, help) rows for SHOW / info_schema."""
        with self._lock:
            return [(n, f.value, f.default, f.help)
                    for n, f in sorted(self._flags.items())]

    # -- startup channels -------------------------------------------------
    def load_args(self, args: list[str],
                  ignore_unknown: bool = False) -> list[str]:
        """Apply ``--name=value`` / ``--name value`` / ``--noname`` pairs;
        returns the non-flag remainder."""
        rest: list[str] = []
        i = 0
        while i < len(args):
            a = args[i]
            if not a.startswith("--"):
                rest.append(a)
                i += 1
                continue
            body = a[2:]
            if "=" in body:
                name, value = body.split("=", 1)
            elif (i + 1 < len(args) and not args[i + 1].startswith("--")
                  and self._is_known(body)
                  and not isinstance(self._default_of(body), bool)):
                name, value = body, args[i + 1]
                i += 1
            elif body.startswith("no") and self._is_known(body[2:]) \
                    and isinstance(self._default_of(body[2:]), bool):
                name, value = body[2:], "false"
            else:
                name, value = body, "true"
            try:
                self.set_flag(name, value)
            except FlagError:
                if not ignore_unknown:
                    raise
            i += 1
        return rest

    def load_file(self, path: str, ignore_unknown: bool = False) -> None:
        """gflags.conf syntax: one ``--name=value`` per line, # comments."""
        with open(path) as f:
            lines = [ln.strip() for ln in f]
        args = [ln for ln in lines if ln and not ln.startswith("#")]
        self.load_args(args, ignore_unknown=ignore_unknown)

    def _is_known(self, name: str) -> bool:
        with self._lock:
            return name in self._flags

    def _default_of(self, name: str):
        with self._lock:
            return self._flags[name].default


FLAGS = FlagRegistry()
define = FLAGS.define
set_flag = FLAGS.set_flag


# -- core engine flags (module-level so they exist before first use) -------
define("onehot_max_segments", 512,
       "dense group-by: the hand-written group-by kernels engage above this "
       "many segments (kept equal to the JAX package's gate)")
define("pallas_group_kernels", True,
       "dense group-by with 512 < groups <= 4096 goes through the hand-"
       "written CUDA kernels (ops/group_kernels.py); the name is kept so a "
       "SET GLOBAL works on both packages")
define("slow_query_ms", 1000.0,
       "a traced query slower than this is kept whatever the sampler says "
       "(obs/trace.py)")
