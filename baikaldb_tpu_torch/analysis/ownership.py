"""GUARDEDBY / LOCKHELDBLOCK / ATOMICITY: lockset race detection.

LOCKORDER (locks.py) proves locks are *acquired* in a consistent order;
this module proves guarded state is *accessed under its lock* — the
RacerD-style other half.  Three phases:

1. **Guarded-by inference.**  For every class owning a lock attribute
   (``self._mu = threading.Lock()`` — locks.py's discovery spellings), an
   instance attribute whose mutation sites are predominantly (strict
   majority, ``__init__`` excluded) inside ``with self._mu:`` bodies is
   *owned* by that lock.  Module-level dicts/sets/lists guarded by
   module-level locks are inferred the same way.  Helper methods whose
   every intra-package call site holds the lock (or that follow the
   ``*_locked`` naming convention) count as guarded — the lock is held
   through the caller.

2. **Race flagging (GUARDEDBY).**  The call graph (callgraph.py) marks a
   class *concurrent* when any of its methods is reachable from a spawned
   thread / RPC handler / loop-entry root; the main thread is an implicit
   second root.  Every read or write of owned state in a concurrent class
   on a path that does not hold the owning lock is a finding.  Ownership
   needs a strict majority on purpose: a class that is sloppy everywhere
   never had a locking discipline to enforce, while a disciplined class
   that forgot the lock *once* is exactly the bug this rule exists for.

3. **Blocking + atomicity (LOCKHELDBLOCK, ATOMICITY).**  LOCKHELDBLOCK
   flags calls that block the host — ``time.sleep``, RPC round-trips
   (``send_msg``/``recv_msg``/client ``.call``), ``host_read`` /
   ``torch.cuda.synchronize`` syncs, file/subprocess I/O — while any discovered
   lock is held: every thread queued on that lock inherits the stall
   (LOCKORDER's sync-under-lock check generalized beyond HOSTSYNC taint).
   ATOMICITY flags check-then-act: an ``if`` whose test reads owned state
   *outside* the lock and whose body re-acquires the lock to act on the
   same state — the decision is stale by the time the lock arrives.

``OwnershipGraph.check`` also returns the inferred ownership map
(``"module:Class" -> {attr: lock_attr}``), exported through
``run_lint.last_ownership`` and consumed by analysis/runtime.py's lockset
witness (``debug_guards``): the static model is asserted against real
interleavings by the stress/chaos suites.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .locks import _is_lock_ctor
from .taint import ModuleIndex

# attribute-name endings that look like locks in a with-item (locks.py)
_LOCKISH = ("lock", "mu", "mutex", "_lk")

# container-method calls that mutate the receiver
_MUTATORS = frozenset({
    "append", "appendleft", "add", "remove", "discard", "clear", "update",
    "setdefault", "pop", "popleft", "popitem", "insert", "extend",
    "move_to_end", "put",
})

# flagging exclusions: construction happens before the object is published
_PREPUBLISH = frozenset({"__init__", "__new__", "__del__"})

# module-global container constructors worth tracking
_CONTAINER_CTORS = frozenset({
    "dict", "set", "list", "defaultdict", "OrderedDict", "deque", "Counter",
})

# resolved call targets that block the host (LOCKHELDBLOCK); tail-matched
# names cover the from-import spellings (``from .net import send_msg``)
_BLOCKING_PATHS = {
    "time.sleep": "time.sleep",
    "torch.cuda.synchronize": "device->host sync",
    "subprocess.run": "subprocess",
    "subprocess.check_output": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.Popen": "subprocess",
    "socket.create_connection": "network connect",
    "os.fsync": "file I/O",
    "os.replace": "file I/O",
    "open": "file I/O",
}
_BLOCKING_TAILS = {
    "send_msg": "network I/O",
    "recv_msg": "network I/O",
    "host_read": "device->host sync",
}
# obj.call()/obj.try_call() is an RPC round-trip when the receiver is
# named like a client handle; bare ``.call`` alone is too generic
_RPCISH_RECEIVERS = ("client", "peer", "rpc", "stub", "cli", "conn")


@dataclass(frozen=True)
class _Access:
    scope: tuple            # ("cls", name) | ("mod", None)
    attr: str
    line: int
    mut: bool
    held: frozenset         # raw lock refs held at the access site
    func: tuple             # (cls, fname, lineno) of the enclosing function
    rebind: bool = False    # mutation is a whole-attribute ``x = ...``


@dataclass
class _OwnFunc:
    cls: str | None
    name: str
    line: int
    localized: frozenset = frozenset()   # bare names bound locally

    @property
    def key(self) -> tuple:
        return (self.cls, self.name, self.line)


class _FileOwnerPass(ast.NodeVisitor):
    """One file: lock defs, state accesses with their held-lock context,
    call sites (for held-through-caller), blocking calls, if-guard shapes."""

    def __init__(self, module: str, tree: ast.AST):
        self.module = module
        self.mi = ModuleIndex(tree)
        self.class_locks: dict[str, list[str]] = {}   # cls -> lock attrs
        self.module_locks: list[str] = []
        self.mod_state: set[str] = set()              # module-level containers
        self.accesses: list[_Access] = []
        # (callee_ref, held_frozenset, caller_func_key)
        self.calls: list[tuple] = []
        # (held_refs_tuple, line, desc, dotted_path, caller_func_key) —
        # recorded for EVERY blocking-shaped call; attribution to a lock
        # (lexically held or held through every caller) happens at check
        self.blocking: list[tuple] = []
        # (scope, attr, lock_ref, if_line, caller_func_key): test read the
        # attr without the lock, body touched it under the lock
        self.atomicity: list[tuple] = []
        self.funcs: list[_OwnFunc] = []
        self._cls: str | None = None
        self._fn: _OwnFunc | None = None
        self._held: list[tuple] = []
        self._ifs: list[dict] = []      # open if-contexts
        self._skip: set[int] = set()    # node ids already recorded
        self.visit(tree)

    # -- structure ----------------------------------------------------------

    def visit_ClassDef(self, node):
        prev, self._cls = self._cls, node.name
        self.generic_visit(node)
        self._cls = prev

    def visit_FunctionDef(self, node):
        localized = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, (ast.Store, ast.Del)):
                localized.add(sub.id)
            elif isinstance(sub, (ast.Global, ast.Nonlocal)):
                localized.difference_update(sub.names)
        prev_fn, prev_held, prev_ifs = self._fn, self._held, self._ifs
        self._fn = _OwnFunc(self._cls, node.name, node.lineno,
                            frozenset(localized))
        self.funcs.append(self._fn)
        self._held, self._ifs = [], []
        for arg_default in node.args.defaults + node.args.kw_defaults:
            if arg_default is not None:
                self.visit(arg_default)
        for stmt in node.body:
            self.visit(stmt)
        self._fn, self._held, self._ifs = prev_fn, prev_held, prev_ifs

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- definitions & mutations --------------------------------------------

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call) and \
                _is_lock_ctor(self.mi.resolve(node.value.func)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self" and self._cls:
                    self.class_locks.setdefault(
                        self._cls, []).append(tgt.attr)
                elif isinstance(tgt, ast.Name) and self._fn is None:
                    self.module_locks.append(tgt.id)
            return
        if self._fn is None:
            # module level: collect container defs, skip access tracking
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and self._is_container(
                        node.value):
                    self.mod_state.add(tgt.id)
            self.visit(node.value)
            return
        for tgt in node.targets:
            # a plain ``self.x = ...`` is an atomic reference swap under
            # the GIL — _record keeps that distinction for swap-publish
            self._record_target(tgt, node.lineno, rebind=True)
        self.visit(node.value)

    @staticmethod
    def _is_container(value) -> bool:
        if isinstance(value, (ast.Dict, ast.Set, ast.List, ast.DictComp,
                              ast.SetComp, ast.ListComp)):
            return True
        return isinstance(value, ast.Call) and \
            isinstance(value.func, ast.Name) and \
            value.func.id in _CONTAINER_CTORS

    def visit_AugAssign(self, node):
        if self._fn is not None:
            self._record_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_Delete(self, node):
        if self._fn is not None:
            for tgt in node.targets:
                self._record_target(tgt, node.lineno)

    def _record_target(self, tgt, line, rebind=False):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._record_target(elt, line, rebind)
        elif isinstance(tgt, ast.Starred):
            self._record_target(tgt.value, line, rebind)
        elif isinstance(tgt, ast.Attribute):
            if isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                self._record("cls", tgt.attr, line, mut=True, rebind=rebind)
            else:
                self.visit(tgt.value)
        elif isinstance(tgt, ast.Subscript):
            base = tgt.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                self._record("cls", base.attr, line, mut=True)
            elif isinstance(base, ast.Name) and base.id in self.mod_state:
                self._record("mod", base.id, line, mut=True)
            else:
                self.visit(base)
            self.visit(tgt.slice)
        elif isinstance(tgt, ast.Name):
            if tgt.id in self.mod_state:
                self._record("mod", tgt.id, line, mut=True, rebind=rebind)

    # -- reads, calls, blocking ---------------------------------------------

    def visit_Attribute(self, node):
        if id(node) in self._skip:
            self.visit(node.value)      # still descend into the receiver
            return
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and isinstance(node.ctx, ast.Load) and self._fn is not None:
            self._record("cls", node.attr, node.lineno, mut=False)
            return
        self.visit(node.value)

    def visit_Name(self, node):
        if id(node) in self._skip:
            return
        if isinstance(node.ctx, ast.Load) and self._fn is not None and \
                node.id in self.mod_state:
            self._record("mod", node.id, node.lineno, mut=False)

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            self._skip.add(id(fn))
            base = fn.value
            if fn.attr in _MUTATORS and self._fn is not None:
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self":
                    self._skip.add(id(base))
                    self._record("cls", base.attr, node.lineno, mut=True)
                elif isinstance(base, ast.Name) and base.id in self.mod_state:
                    self._skip.add(id(base))
                    self._record("mod", base.id, node.lineno, mut=True)
            # callee ref for held-through-caller resolution
            if isinstance(base, ast.Name) and base.id == "self":
                self._add_call(("method", self._cls, fn.attr))
            else:
                self._add_call(("anymethod", None, fn.attr))
        elif isinstance(fn, ast.Name):
            self._add_call(("func", None, fn.id))
        if self._fn is not None:
            self._classify_blocking(node)
        self.generic_visit(node)

    def _add_call(self, ref):
        if self._fn is not None:
            self.calls.append((ref, frozenset(self._held), self._fn.key))

    def _classify_blocking(self, node):
        path = self.mi.resolve(node.func)
        desc = None
        if path is not None:
            desc = _BLOCKING_PATHS.get(path) \
                or _BLOCKING_TAILS.get(path.rsplit(".", 1)[-1])
        if desc is None and isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("call", "try_call"):
            recv = node.func.value
            name = recv.attr if isinstance(recv, ast.Attribute) else (
                recv.id if isinstance(recv, ast.Name) else "")
            if any(tag in name.lower() for tag in _RPCISH_RECEIVERS):
                desc, path = "RPC round-trip", f"{name}.{node.func.attr}"
        if desc is not None:
            self.blocking.append((tuple(self._held), node.lineno, desc,
                                  path, self._fn.key))

    # -- lock scopes & if-guard shapes --------------------------------------

    def _lock_ref(self, expr):
        if isinstance(expr, ast.Attribute) and expr.attr.endswith(_LOCKISH):
            return ("attr", expr.attr, self._cls
                    if isinstance(expr.value, ast.Name) and
                    expr.value.id == "self" else None)
        if isinstance(expr, ast.Name) and expr.id.endswith(_LOCKISH):
            return ("name", expr.id, None)
        return None

    def visit_With(self, node):
        refs = []
        for item in node.items:
            self.visit(item.context_expr)
            ref = self._lock_ref(item.context_expr)
            if ref is not None and self._fn is not None:
                refs.append(ref)
                self._held.append(ref)
        for stmt in node.body:
            self.visit(stmt)
        for _ in refs:
            self._held.pop()

    visit_AsyncWith = visit_With

    def visit_If(self, node):
        ctx = None
        if self._fn is not None:
            test_attrs = set()
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Attribute) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == "self":
                    test_attrs.add(("cls", sub.attr))
                elif isinstance(sub, ast.Name) and sub.id in self.mod_state:
                    test_attrs.add(("mod", sub.id))
            if test_attrs:
                ctx = {"attrs": test_attrs, "held": frozenset(self._held),
                       "line": node.lineno, "func": self._fn.key}
        self.visit(node.test)
        if ctx is not None:
            self._ifs.append(ctx)
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        if ctx is not None:
            self._ifs.pop()

    # -- recording ----------------------------------------------------------

    def _record(self, kind, attr, line, mut, rebind=False):
        if self._fn is None:
            return
        scope = (kind, self._cls) if kind == "cls" else (kind, None)
        held = frozenset(self._held)
        self.accesses.append(_Access(scope, attr, line, mut, held,
                                     self._fn.key, rebind))
        # check-then-act: this access is under a lock the enclosing if's
        # test did NOT hold while reading the same state
        key = (kind, attr)
        for ref in self._held:
            for ctx in self._ifs:
                if key in ctx["attrs"] and ref not in ctx["held"]:
                    self.atomicity.append(
                        ((kind, self._cls if kind == "cls" else None),
                         attr, ref, ctx["line"], ctx["func"]))


@dataclass(frozen=True)
class OwnerFinding:
    rule: str
    module: str
    line: int
    msg: str


class OwnershipGraph:
    """Package-wide aggregation; ``check`` yields the three rules'
    findings plus the inferred ownership map."""

    def __init__(self):
        self._files: list[_FileOwnerPass] = []

    def add_file(self, module: str, tree: ast.AST) -> None:
        self._files.append(_FileOwnerPass(module, tree))

    # -- resolution ---------------------------------------------------------

    def _lock_name(self, fp: _FileOwnerPass, ref) -> str | None:
        """Resolve a raw held ref to a lock identity string
        ``module:Cls.attr`` / ``module:name`` using the discovered defs."""
        kind, name, cls = ref
        if kind == "attr":
            if cls is not None and name in fp.class_locks.get(cls, ()):
                return f"{fp.module}:{cls}.{name}"
            owners = [(fp.module, c) for c, attrs in fp.class_locks.items()
                      if name in attrs]
            if not owners:   # cross-file: unique attr name in the package
                owners = [(o.module, c) for o in self._files
                          for c, attrs in o.class_locks.items()
                          if name in attrs]
            if len(owners) == 1:
                return f"{owners[0][0]}:{owners[0][1]}.{name}"
            return None
        if name in fp.module_locks:
            return f"{fp.module}:{name}"
        return None

    def _holds(self, fp, access_held, cls, lock_attr) -> bool:
        for kind, name, hcls in access_held:
            if kind == "attr" and name == lock_attr and \
                    (hcls == cls or hcls is None):
                return True
        return False

    def _holds_mod(self, access_held, lock_name) -> bool:
        return any(kind == "name" and name == lock_name
                   for kind, name, _ in access_held)

    # -- held-through-caller fixpoint ---------------------------------------

    def _locked_context(self) -> dict:
        """(module, cls, fname) -> set of lock attrs held at EVERY intra-
        package call site — the lock is held *through the caller*, so the
        function's body is effectively inside the critical section.  The
        ``*_locked`` naming convention seeds the fixpoint; one iteration
        per nesting level closes chains like call -> _call_retrying ->
        _recv_cancellable."""
        sites: dict[tuple, list] = {}
        for fp in self._files:
            for ref, held, caller in fp.calls:
                kind, cls, name = ref
                tgt_mod = fp.module if kind in ("method", "func") else None
                sites.setdefault((tgt_mod, cls, name), []).append(
                    (fp.module, held, caller))
        out: dict[tuple, set] = {}
        for fp in self._files:
            for f in fp.funcs:
                if f.name.endswith("_locked") and f.cls is not None:
                    out.setdefault((fp.module, f.cls, f.name), set()).update(
                        fp.class_locks.get(f.cls, ()))
        for _ in range(8):          # fixpoint over call-chain depth
            changed = False
            for fp in self._files:
                for f in fp.funcs:
                    if f.cls is None:
                        continue
                    key = (fp.module, f.cls, f.name)
                    callers = sites.get((fp.module, f.cls, f.name), []) + \
                        sites.get((None, None, f.name), [])
                    if not callers:
                        continue
                    for lock_attr in fp.class_locks.get(f.cls, ()):
                        if lock_attr in out.get(key, ()):
                            continue
                        if all(self._holds(None, held, f.cls, lock_attr)
                               or lock_attr in out.get(
                                   (cmod, c[0], c[1]), ())
                               for cmod, held, c in callers):
                            out.setdefault(key, set()).add(lock_attr)
                            changed = True
            if not changed:
                break
        return out

    # -- analysis -----------------------------------------------------------

    def check(self, callgraph) -> tuple[list[OwnerFinding], dict]:
        findings: list[OwnerFinding] = []
        ownership: dict[str, dict[str, str]] = {}
        locked_ctx = self._locked_context()
        concurrent = callgraph.concurrent_classes() if callgraph else set()

        for fp in self._files:
            self._check_classes(fp, callgraph, concurrent, locked_ctx,
                                ownership, findings)
            self._check_module_state(fp, callgraph, findings)
            self._check_blocking(fp, locked_ctx, findings)
        findings.sort(key=lambda f: (f.module, f.line, f.rule))
        return findings, ownership

    def _guarded(self, fp, acc: _Access, cls, lock_attr, locked_ctx) -> bool:
        if self._holds(fp, acc.held, cls, lock_attr):
            return True
        fcls, fname, fline = acc.func
        return lock_attr in locked_ctx.get((fp.module, fcls, fname), ())

    def _check_classes(self, fp, callgraph, concurrent, locked_ctx,
                       ownership, findings):
        for cls, lock_attrs in fp.class_locks.items():
            accs = [a for a in fp.accesses
                    if a.scope == ("cls", cls) and a.attr not in lock_attrs]
            by_attr: dict[str, list[_Access]] = {}
            for a in accs:
                by_attr.setdefault(a.attr, []).append(a)
            owned: dict[str, str] = {}
            for attr, alist in by_attr.items():
                muts = [a for a in alist if a.mut
                        and a.func[1] not in _PREPUBLISH]
                best, best_n = None, 0
                for lk in lock_attrs:
                    n = sum(1 for m in muts
                            if self._guarded(fp, m, cls, lk, locked_ctx))
                    if n > best_n:
                        best, best_n = lk, n
                # strict majority: a disciplined class that slipped once is
                # the target; a class with no discipline is not inferred
                if best is not None and 2 * best_n > len(muts):
                    owned[attr] = best
            # the exported map (the runtime witness's assertion input)
            # excludes swap-published attrs: their lockless reads are
            # legal (see the downgrade below), so a per-read runtime
            # assertion on them would trip on correct code
            exported = {
                attr: lk for attr, lk in owned.items()
                if not all(a.rebind for a in by_attr[attr] if a.mut)}
            if exported:
                ownership[f"{fp.module}:{cls}"] = exported
            if (fp.module, cls) not in concurrent:
                continue
            for attr, lk in sorted(owned.items()):
                # swap-publish downgrade: when EVERY mutation site is a
                # whole-attribute rebind (never subscript/aug/del/mutator),
                # an unguarded read is an atomic reference load under the
                # GIL — the copy-then-rebind publish idiom (catalog _snap,
                # binlog _table) is safe by construction.  Unguarded
                # WRITES still race (lost update between two rebinds).
                swap_pub = all(a.rebind for a in by_attr[attr] if a.mut)
                for a in by_attr[attr]:
                    if a.func[1] in _PREPUBLISH or \
                            (not a.mut and swap_pub) or \
                            self._guarded(fp, a, cls, lk, locked_ctx):
                        continue
                    kind = "write to" if a.mut else "read of"
                    findings.append(OwnerFinding(
                        "GUARDEDBY", fp.module, a.line,
                        f"unguarded {kind} {cls}.{attr} (owned by "
                        f"self.{lk}: its other mutation sites hold the "
                        f"lock, and {cls} runs on >= 2 threads) — take "
                        f"the lock or move the access under an existing "
                        "critical section"))
                self._check_atomicity(fp, ("cls", cls), attr, lk, findings)

    def _check_module_state(self, fp, callgraph, findings):
        if not fp.module_locks or not fp.mod_state:
            return
        by_name: dict[str, list[_Access]] = {}
        for a in fp.accesses:
            if a.scope == ("mod", None):
                fn = next((f for f in fp.funcs
                           if f.key == a.func), None)
                if fn is not None and a.attr in fn.localized:
                    continue        # locally shadowed name, not the global
                by_name.setdefault(a.attr, []).append(a)
        for name, alist in by_name.items():
            muts = [a for a in alist if a.mut]
            best, best_n = None, 0
            for lk in fp.module_locks:
                n = sum(1 for m in muts if self._holds_mod(m.held, lk))
                if n > best_n:
                    best, best_n = lk, n
            if best is None or 2 * best_n <= len(muts):
                continue
            hot = callgraph is not None and any(
                callgraph.spawned_roots_of(fp.module, f[0], f[1], f[2])
                for f in {a.func for a in alist})
            if not hot:
                continue
            swap_pub = all(a.rebind for a in muts)
            for a in alist:
                if self._holds_mod(a.held, best) or \
                        (not a.mut and swap_pub):
                    continue
                kind = "write to" if a.mut else "read of"
                findings.append(OwnerFinding(
                    "GUARDEDBY", fp.module, a.line,
                    f"unguarded {kind} module state {name} (owned by "
                    f"{best}: its other mutation sites hold the lock) — "
                    "take the lock around the access"))
            self._check_atomicity(fp, ("mod", None), name, best, findings)

    def _check_atomicity(self, fp, scope, attr, lock_attr, findings):
        seen = set()
        for a_scope, a_attr, ref, if_line, func in fp.atomicity:
            if a_scope != scope or a_attr != attr:
                continue
            kind, name, cls = ref
            if name != lock_attr or (if_line, a_attr) in seen:
                continue
            seen.add((if_line, a_attr))
            label = f"self.{lock_attr}" if scope[0] == "cls" else lock_attr
            findings.append(OwnerFinding(
                "ATOMICITY", fp.module, if_line,
                f"check-then-act on {attr}: the if-test reads it without "
                f"{label} but the body re-acquires the lock to act on it "
                "— the checked state can change before the lock arrives; "
                "take the lock around the whole check+act sequence"))

    def _check_blocking(self, fp, locked_ctx, findings):
        for held_refs, line, desc, path, func in fp.blocking:
            names = [n for n in (self._lock_name(fp, r)
                                 for r in reversed(held_refs)) if n]
            fcls, fname, _fline = func
            for lock_attr in sorted(
                    locked_ctx.get((fp.module, fcls, fname), ())):
                if fcls is not None and \
                        lock_attr in fp.class_locks.get(fcls, ()):
                    names.append(
                        f"{fp.module}:{fcls}.{lock_attr} (held through "
                        "every caller)")
            if not names:
                continue
            findings.append(OwnerFinding(
                "LOCKHELDBLOCK", fp.module, line,
                f"{desc} ({path}) while holding {names[0]}: every thread "
                "queued on the lock inherits the stall — move the "
                "blocking call outside the critical section or snapshot "
                "state under the lock and act after release"))


# -- runtime witness export ---------------------------------------------

_PKG_OWNERSHIP: dict | None = None


def package_ownership(refresh: bool = False,
                      pkg_dir: str | None = None) -> dict:
    """Inferred ownership map of a package tree, keyed
    ``"<package>/<mod>.py:Class" -> {attr: lock_attr}`` — the input the
    runtime lockset witness (analysis/runtime.py) arms its per-attribute
    assertions from.  ``pkg_dir`` defaults to this package; its own map is
    parsed once per process (``refresh`` re-runs), another tree's on every
    call."""
    global _PKG_OWNERSHIP
    import os
    own = pkg_dir is None
    if own and _PKG_OWNERSHIP is not None and not refresh:
        return _PKG_OWNERSHIP
    if own:
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg_dir = os.path.abspath(pkg_dir)
    root = os.path.dirname(pkg_dir)
    from .callgraph import CallGraph
    graph, cg = OwnershipGraph(), CallGraph()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue
            graph.add_file(rel, tree)
            cg.add_file(rel, tree)
    _, ownership = graph.check(cg)
    if own:
        _PKG_OWNERSHIP = ownership
    return ownership
