"""Runtime enforcement of the statically-linted invariants (debug_guards).

The lint proves the *source* clean; this module catches what static
analysis cannot see — dynamically-dispatched host syncs and lock
acquisitions — by arming two guards when the ``debug_guards`` flag is
"log" or "disallow":

- ``hot_path_guard(device)`` wraps the plan's execution on a CUDA device
  in torch's sync debug mode: any implicit device->host read inside the
  hot path (a stray ``int(t)`` / ``.item()`` / ``.cpu()`` / branch on a
  tensor / data-dependent shape) logs or fails the query instead of
  silently stalling the host.  ``host_read(x)`` is the one sanctioned
  spelling of a read that is there by design: it lifts the guard for
  exactly that read.
- ``GuardedLock`` is a drop-in threading.Lock/RLock whose acquisitions
  assert the statically-derived lock ORDER (tools/lint.py --lock-order):
  every lock carries a rank, and acquiring a lower/equal rank while holding
  a higher one is an inversion — the dynamic half of LOCKORDER.
  tests/test_torch_lint.py cross-checks the declared ranks against the
  static acquisition graph, so the two layers cannot drift apart.
- the **lockset witness** is the dynamic half of GUARDEDBY
  (analysis/ownership.py): classes call ``register_witness`` with their
  statically-inferred ``{attr: lock}`` ownership, and arming the flag
  installs ``_OwnedAttr`` data descriptors that assert every access to an
  owned attribute happens while the owning ``GuardedLock`` is held by the
  accessing thread — the static model checked against real interleavings
  by the stress/chaos suites.

Trips surface in ``metrics`` (``guard_transfer_trips`` /
``guard_lock_trips`` / ``guard_owner_trips``) and on the EXPLAIN ANALYZE
``-- guards:`` line.

What counts as a transfer: torch's sync debug mode flags every blocking
copy, both ways.  As in the JAX package, only device->host reads are
trips; a host->device upload (a literal, a host table's column, an index
list) stays allowed.  The scope therefore runs its thread's torch calls
through ``_UploadMode``, which marks the calls that upload host data, and
a sync inside one of those passes.

The sync guard and threads: torch's sync debug mode is process-wide, while
a guard scope belongs to one thread.  While any scope is open the mode is
held at "warn"; torch's warning ("called a synchronizing CUDA operation")
reaches one handler, which counts a trip only for a thread inside a scope
and outside ``host_read``, raises there under disallow, and drops the
warning for every other thread (another session's egress, the dispatcher's
tick, the telemetry poller).  A trip's exception propagates out of the
torch op that synced; should a caller swallow it, the scope's exit raises
instead.  ``host_read`` turns the mode off for its one read, so a sync
another thread makes in that window goes unseen — the same best-effort
window as ``GuardedLock``'s flag flip.

CPU caveat: a CPU tensor's read is no transfer, and the guard never
touches ``torch.cuda`` for a CPU device — the transfer half of
debug_guards is a no-op on the CPU and bites on the card, which is exactly
where the sync costs a round-trip.  The lock half is backend-independent.
This module imports torch only inside the calls that use it: the store
and meta daemons take their locks from here and never load torch.
"""

from __future__ import annotations

import os
import sys
import threading
import warnings
import contextlib
from contextlib import contextmanager

from ..obs import trace
from ..utils import metrics
from ..utils.flags import FLAGS, define

define("debug_guards", "off",
       "runtime trace/transfer/lock guards on the hot path: off | log "
       "(transfers logged to stderr, trips counted) | disallow "
       "(fail the query/acquisition; trips counted) — the dynamic half of "
       "baikaldb_tpu_torch/tools/lint.py")

guard_transfer_trips = metrics.Counter("guard_transfer_trips")
guard_lock_trips = metrics.Counter("guard_lock_trips")
guard_owner_trips = metrics.Counter("guard_owner_trips")

# the flag is re-read on every lock acquisition of the hottest paths:
# cache the resolved mode and refresh through the flag listener instead
_MODE = "off"


def _refresh_mode(value=None) -> None:
    global _MODE
    mode = str(FLAGS.debug_guards if value is None else value).lower()
    _MODE = mode if mode in ("log", "disallow") else "off"
    _arm_witnesses(_MODE != "off")


# -- lockset witness (dynamic GUARDEDBY) ---------------------------------

# registered classes: cls -> (static_id, {attr: lock_attr}); descriptors
# are installed/removed as the flag flips so production classes stay
# plain-attribute fast when guards are off
_WITNESSES: dict = {}
_ARMED = False


class _OwnedAttr:
    """Data descriptor asserting accesses to a lock-owned instance
    attribute happen while the owning lock is held BY THIS THREAD.  The
    value itself lives in the instance ``__dict__`` (the descriptor wins
    the lookup because it is a data descriptor); the first ``__set__``
    (construction, before the object is published) is exempt."""

    def __init__(self, name: str, lock_attr: str, static_id: str):
        self.name = name
        self.lock_attr = lock_attr
        self.static_id = static_id

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            val = obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None
        self._check(obj, "read")
        return val

    def __set__(self, obj, value):
        if self.name in obj.__dict__:      # first set = construction
            self._check(obj, "write")
        obj.__dict__[self.name] = value

    def __delete__(self, obj):
        self._check(obj, "delete")
        del obj.__dict__[self.name]

    def _check(self, obj, verb: str) -> None:
        if _MODE == "off":      # descriptors may outlive a flag flip
            return
        lk = getattr(obj, self.lock_attr, None)
        if lk is None:
            return
        if isinstance(lk, GuardedLock):
            held = lk.held_by_me()
        else:                   # plain lock: best effort (any holder)
            held = bool(getattr(lk, "locked", lambda: True)())
        if held:
            return
        guard_owner_trips.add(1)
        msg = (f"lockset witness: {verb} of {self.static_id}.{self.name} "
               f"without holding self.{self.lock_attr} (statically "
               "inferred owner — analysis/ownership.py)")
        if _MODE == "disallow":
            raise RuntimeError(msg)
        print(f"tpulint-guard: {msg}", file=sys.stderr)


def register_witness(cls, static_id: str,
                     attrs: dict | None = None) -> None:
    """Enroll ``cls`` in the lockset witness.  ``attrs`` ({attr:
    lock_attr}) defaults to the static pass's inferred ownership for
    ``static_id`` (``analysis.ownership.package_ownership()``), resolved
    lazily at ARM time so import-time registration costs nothing.
    Installs immediately if guards are already armed."""
    if getattr(cls, "__slots__", None) is not None:
        return                  # no instance __dict__ to host the values
    _WITNESSES[cls] = (static_id, attrs)
    if _ARMED:
        _install_witness(cls, static_id, attrs)


def _resolve_attrs(static_id: str, attrs: dict | None) -> dict:
    if attrs is not None:
        return attrs
    from .ownership import package_ownership
    return dict(package_ownership().get(static_id, {}))


def _install_witness(cls, static_id, attrs) -> None:
    for attr, lock_attr in _resolve_attrs(static_id, attrs).items():
        if not isinstance(cls.__dict__.get(attr), _OwnedAttr):
            setattr(cls, attr, _OwnedAttr(attr, lock_attr, static_id))


def _arm_witnesses(on: bool) -> None:
    global _ARMED
    if on == _ARMED:
        return
    _ARMED = on
    for cls, (static_id, attrs) in _WITNESSES.items():
        if on:
            _install_witness(cls, static_id, attrs)
        else:
            for attr, cur in list(cls.__dict__.items()):
                if isinstance(cur, _OwnedAttr):
                    delattr(cls, attr)


def witness_stats() -> dict:
    """Introspection: armed state + per-class witnessed attrs (resolved
    view — triggers the static parse when defaults are in play)."""
    return {"armed": _ARMED,
            "classes": {sid: sorted(_resolve_attrs(sid, attrs))
                        for sid, attrs in _WITNESSES.values()}}


_refresh_mode()
FLAGS.on_change("debug_guards", _refresh_mode)


def guard_mode() -> str:
    return _MODE


# -- the sync guard (dynamic HOSTSYNC) -----------------------------------

# torch's text for a sync under its debug mode (c10 warn_or_error_on_sync)
SYNC_TEXT = "called a synchronizing CUDA operation"

_tls = threading.local()       # depth: open scopes; lifted: host_read depth
_sync_mu = threading.Lock()    # process-wide mode bookkeeping only
_open_scopes = 0
_lifted = 0
_prev_showwarning = None


def _set_sync_mode(mode: str) -> None:
    import torch
    torch.cuda.set_sync_debug_mode(mode)


def _caller() -> tuple[str, int]:
    """File and line of the innermost frame outside this module, torch and
    warnings: the code whose torch call synced (torch attributes its
    warning to the innermost Python frame, which is ``_UploadMode``'s)."""
    import os
    skip = (os.path.abspath(__file__), os.sep + "torch" + os.sep, os.sep + "warnings.py")
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(k in fn for k in skip):
            return fn, f.f_lineno
        f = f.f_back
    return "?", 0


def _on_warning(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` while a scope is open: torch's sync
    warnings are this module's; every other warning goes on as before."""
    prev = _prev_showwarning or warnings._showwarning_orig
    if SYNC_TEXT not in str(message):
        return prev(message, category, filename, lineno, file, line)
    if getattr(_tls, "depth", 0) <= 0 or getattr(_tls, "lifted", 0) > 0 \
            or getattr(_tls, "uploading", 0) > 0:
        return                  # another thread's sync, a host_read or an upload
    guard_transfer_trips.add(1)
    filename, lineno = _caller()
    if _MODE == "disallow":
        msg = (f"debug_guards: implicit device->host transfer inside the hot "
               f"path ({SYNC_TEXT} at {filename}:{lineno}) — keep it on the "
               "device or spell it host_read(...)")
        _tls.tripped = msg
        raise RuntimeError(msg)
    # log: torch's own warning goes on, attributed to the syncing caller
    prev(message, category, filename, lineno, file, line)


def _on_card(x) -> bool:
    return getattr(getattr(x, "device", None), "type", None) == "cuda"


def _holds_card_tensor(data) -> bool:
    if isinstance(data, (list, tuple)):
        return any(_holds_card_tensor(d) for d in data)
    return _on_card(data)


def _is_upload(func, args, kwargs) -> bool:
    """Whether a torch call copies host data to the card: a factory over
    host data with a CUDA ``device``, ``.to`` / ``.cuda`` / ``.copy_`` from
    a CPU tensor onto the card, or a host index list or tensor into a card
    tensor."""
    import torch
    T = torch.Tensor
    if func in (torch.tensor, torch.as_tensor, torch.asarray):
        dev = kwargs.get("device")
        return dev is not None and str(dev).startswith("cuda") \
            and not (args and _holds_card_tensor(args[0]))
    if func in (T.to, T.cuda):
        return bool(args) and isinstance(args[0], T) and not _on_card(args[0])
    if func is T.copy_:
        return len(args) > 1 and _on_card(args[0]) and not _on_card(args[1])
    if func in (T.__getitem__, T.__setitem__) and len(args) > 1 and _on_card(args[0]):
        idx = args[1] if isinstance(args[1], tuple) else (args[1],)
        host = [i for i in idx if isinstance(i, (list, T)) or hasattr(i, "__array__")]
        val = args[2] if func is T.__setitem__ and len(args) > 2 else None
        return (bool(host) and not any(_holds_card_tensor(i) for i in host)) or \
            (isinstance(val, T) and not _on_card(val))
    return False


def _upload_mode():
    """A TorchFunctionMode marking this thread's uploads (see the module
    docstring); built on first use, so importing this module loads no
    torch."""
    global _UPLOAD_MODE
    if _UPLOAD_MODE is None:
        from torch.overrides import TorchFunctionMode

        class _UploadMode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if not _is_upload(func, args, kwargs):
                    return func(*args, **kwargs)
                _tls.uploading = getattr(_tls, "uploading", 0) + 1
                try:
                    return func(*args, **kwargs)
                finally:
                    _tls.uploading -= 1

        _UPLOAD_MODE = _UploadMode
    return _UPLOAD_MODE()


_UPLOAD_MODE = None


def _install_handler() -> None:
    """Route torch's sync warnings, every one of them, to ``_on_warning``
    (re-done at each outermost scope: a test harness may reset both)."""
    global _prev_showwarning
    if warnings.showwarning is not _on_warning:
        _prev_showwarning = warnings.showwarning
        warnings.showwarning = _on_warning
    if not any(f[0] == "always" and f[1] is not None
               and f[1].pattern == SYNC_TEXT for f in warnings.filters):
        warnings.filterwarnings("always", message=SYNC_TEXT,
                                category=UserWarning)


@contextmanager
def hot_path_guard(device=None):
    """Execution scope for a query's device work on ``device``: no
    implicit device->host read may happen inside.  Egress reads belong
    AFTER this scope; a read that is there by design inside it is spelled
    ``host_read``.  Off, the scope is free; on a CPU device it only keeps
    this thread's scope depth and never touches ``torch.cuda``."""
    global _open_scopes
    if _MODE == "off":
        yield
        return
    cuda = device is not None and getattr(
        device, "type", str(device).split(":")[0]) == "cuda"
    depth = getattr(_tls, "depth", 0)
    if cuda:
        with _sync_mu:
            if _open_scopes == 0:
                _install_handler()
                _set_sync_mode("warn")
            _open_scopes += 1
    _tls.depth = depth + 1
    if depth == 0:
        _tls.tripped = None
    mode_cm = _upload_mode() if cuda and depth == 0 else contextlib.nullcontext()
    ok = False
    try:
        with mode_cm:
            yield
        ok = True
    finally:
        _tls.depth = depth
        if cuda:
            with _sync_mu:
                _open_scopes -= 1
                if _open_scopes == 0 and _lifted == 0:
                    _set_sync_mode("default")
        tripped = getattr(_tls, "tripped", None) if depth == 0 else None
        if depth == 0:
            _tls.tripped = None
        if ok and tripped is not None and _MODE == "disallow":
            # the op's own exception was swallowed on the way out: the
            # query still fails, at the scope's exit
            raise RuntimeError(tripped)


def _read(x, op):
    if op is not None:
        return op(x)
    return x.item() if x.dim() == 0 else x.cpu()


def host_read(x, op=None):
    """The sanctioned device->host read: a 0-dim tensor -> its Python
    scalar (``.item()``), any other tensor -> a CPU tensor (``.cpu()``;
    ``.tolist()`` / ``.numpy()`` of it are host work), anything else as it
    is.  ``op`` instead runs ``op(x)`` for an op whose output shape depends
    on the data (``torch.nonzero``, a boolean-mask gather): the size read
    is the read, and the result stays on the device.  Inside an armed
    ``hot_path_guard`` it lifts the guard for exactly this one read;
    outside, it is the read itself.  Every tensor read counts in
    ``metrics.host_reads``; with a trace live it is a ``host.read`` span
    whose ``site`` names the calling line."""
    import torch
    if not isinstance(x, torch.Tensor):
        return x if op is None else op(x)
    metrics.host_reads.add(1)
    if not trace.active():
        return _guarded_read(x, op)
    with trace.span("host.read", site=_caller_site()):
        return _guarded_read(x, op)


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _caller_site() -> str:
    """``path:line`` of ``host_read``'s caller, the path inside the package."""
    f = sys._getframe(2)
    path = f.f_code.co_filename
    if path.startswith(_PKG_DIR):
        path = path[len(_PKG_DIR):]
    return f"{path}:{f.f_lineno}"


def _guarded_read(x, op):
    """The read, with an armed guard lifted around it."""
    if getattr(_tls, "depth", 0) <= 0:
        return _read(x, op)
    global _lifted
    cuda = x.device.type == "cuda"
    _tls.lifted = getattr(_tls, "lifted", 0) + 1
    if cuda:
        with _sync_mu:
            _lifted += 1
            if _lifted == 1:
                _set_sync_mode("default")
    try:
        return _read(x, op)
    finally:
        _tls.lifted -= 1
        if cuda:
            with _sync_mu:
                _lifted -= 1
                if _lifted == 0 and _open_scopes > 0:
                    _set_sync_mode("warn")


def in_guarded_scope() -> bool:
    """Whether this thread is inside an armed ``hot_path_guard`` and
    outside ``host_read`` — where a device->host read is a trip."""
    return getattr(_tls, "depth", 0) > 0 and getattr(_tls, "lifted", 0) == 0


# declared lock ranks, validated against the static graph by
# tests/test_torch_lint.py (every static edge A->B must have rank[A] < rank[B])
LOCK_RANKS: dict[str, int] = {}


class GuardedLock:
    """threading.Lock/RLock + rank-ordered acquisition assertion.

    With debug_guards off, acquire() is one module-global read plus the
    underlying C lock — no stack bookkeeping, no flag parse.  Arming the
    flag mid-hold therefore starts with an empty view of already-held
    locks (checks engage on the next full acquisition chain); that
    best-effort window is the price of a zero-cost production path."""

    _tls = threading.local()

    def __init__(self, name: str, rank: int, reentrant: bool = False):
        self._lk = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self.rank = rank
        LOCK_RANKS[name] = rank

    @classmethod
    def _stack(cls) -> list:
        st = getattr(cls._tls, "stack", None)
        if st is None:
            st = cls._tls.stack = []
        return st

    def _check_order(self) -> None:
        st = self._stack()
        # re-entering a lock this thread ALREADY holds is always safe
        # (RLock semantics) even if higher-rank locks were taken since
        if self in st:
            return
        # strict >: same-rank locks (two tables' store locks) may nest
        # freely — give locks DISTINCT ranks when their order matters
        if st and st[-1].rank > self.rank:
            guard_lock_trips.add(1)
            msg = (f"lock order violation: acquiring {self.name} "
                   f"(rank {self.rank}) while holding {st[-1].name} "
                   f"(rank {st[-1].rank}) — the static order "
                   "(tools/tpulint.py --lock-order) forbids this nesting")
            if _MODE == "disallow":
                raise RuntimeError(msg)
            print(f"tpulint-guard: {msg}", file=sys.stderr)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _MODE == "off":      # production fast path: no bookkeeping
            return self._lk.acquire(blocking, timeout)
        self._check_order()
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._stack().append(self)
        return ok

    def release(self) -> None:
        if _MODE != "off":
            st = self._stack()
            if st and st[-1] is self:
                st.pop()
            elif self in st:    # out-of-order release: still unwind
                st.remove(self)
        elif getattr(self._tls, "stack", None):
            # flag flipped off mid-hold: drain stale entries lazily
            st = self._tls.stack
            if self in st:
                st.remove(self)
        self._lk.release()

    def __enter__(self) -> "GuardedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        lk = self._lk
        return lk.locked() if hasattr(lk, "locked") else False

    def held_by_me(self) -> bool:
        """Whether THIS thread is inside the lock.  Stack-based, so only
        meaningful while debug_guards is armed (acquisitions made with
        guards off were never pushed — the same best-effort window as
        the order check, see the class docstring)."""
        return self in self._stack()


def guard_stats() -> dict:
    """The EXPLAIN ANALYZE / SHOW METRICS payload."""
    return {"mode": guard_mode(),
            "transfer_trips": guard_transfer_trips.value,
            "lock_trips": guard_lock_trips.value,
            "owner_trips": guard_owner_trips.value}
