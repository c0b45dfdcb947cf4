"""LOCKORDER: package-wide lock acquisition graph + discipline checks.

Phase A (per file) finds lock *definitions* — ``self.NAME =
threading.Lock()/RLock()`` inside a class, ``NAME = threading.Lock()`` at
module level (the analysis/runtime ``GuardedLock`` spellings count too) —
and, per function, the *acquisition structure*: which locks each ``with``
statement holds, which locks/calls happen inside those bodies.

Phase B stitches the package together:

- every nested acquisition ``with A: ... with B:`` adds the edge A -> B;
- calls made while holding A add A -> L for every lock L the callee may
  acquire (call graph limited to same-class methods and same-module
  functions, closed transitively — the resolution a reader can also do);
- a cycle in the resulting graph is a LOCKORDER violation (two threads
  taking the locks in opposite orders deadlock);
- a HOSTSYNC finding lexically inside a with-lock body is a LOCKORDER
  violation too: a blocking device->host round-trip while holding a lock
  stalls every thread queued on it (the binlog retry lock serializes
  thread-per-connection commits — one sync there is a fleet-wide stall).

When the graph is acyclic, ``derived_order`` is a topological order of all
locks that appear in edges — runtime.GuardedLock ranks are validated
against it in tests/test_torch_lint.py, closing the static->runtime loop.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .taint import ModuleIndex

_LOCK_CTORS = ("threading.Lock", "threading.RLock", "GuardedLock",
               "ordered_lock")


def _is_lock_ctor(path: str | None) -> bool:
    return path is not None and any(path.endswith(c) for c in _LOCK_CTORS)


@dataclass(frozen=True)
class LockId:
    module: str             # repo-relative path of the defining file
    cls: str | None         # defining class, None for module-level locks
    attr: str

    def __str__(self) -> str:
        scope = f"{self.cls}." if self.cls else ""
        return f"{self.module}:{scope}{self.attr}"


@dataclass
class _FuncInfo:
    module: str
    cls: str | None
    name: str
    # raw acquisition refs: ("attr", name) for self/obj.NAME, ("name", name)
    acquires: list = field(default_factory=list)
    # (held_raw_ref, callee_key) pairs: call made while holding a lock
    held_calls: list = field(default_factory=list)
    # every callee key in the function (for transitive may-acquire summaries)
    all_calls: list = field(default_factory=list)
    # (held_raw_ref, acquired_raw_ref, line) nested-with edges
    nested: list = field(default_factory=list)
    # (raw_ref, start_line, end_line) with-body line ranges (minus nested
    # defs), for the sync-under-lock check
    held_ranges: list = field(default_factory=list)


class _FileLockPass(ast.NodeVisitor):
    def __init__(self, module: str, tree: ast.AST):
        self.module = module
        self.mi = ModuleIndex(tree)
        self.defs: list[LockId] = []
        self.funcs: list[_FuncInfo] = []
        self._cls: str | None = None
        self._fn: _FuncInfo | None = None
        self._held: list[tuple] = []
        self.visit(tree)

    # -- structure ----------------------------------------------------------

    def visit_ClassDef(self, node):
        prev, self._cls = self._cls, node.name
        self.generic_visit(node)
        self._cls = prev

    def visit_FunctionDef(self, node):
        prev_fn, prev_held = self._fn, self._held
        self._fn = _FuncInfo(self.module, self._cls, node.name)
        self._held = []
        self.funcs.append(self._fn)
        self.generic_visit(node)
        self._fn, self._held = prev_fn, prev_held

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- lock definitions ---------------------------------------------------

    def visit_Assign(self, node):
        if isinstance(node.value, ast.Call) and \
                _is_lock_ctor(self.mi.resolve(node.value.func)):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self" and self._cls:
                    self.defs.append(LockId(self.module, self._cls, tgt.attr))
                elif isinstance(tgt, ast.Name) and self._fn is None:
                    self.defs.append(LockId(self.module, None, tgt.id))
        self.generic_visit(node)

    # -- acquisitions -------------------------------------------------------

    def _lock_ref(self, expr):
        """Raw reference for a with-item that might be a lock."""
        if isinstance(expr, ast.Attribute) and expr.attr.endswith(
                ("lock", "mu", "mutex", "_lk")):
            return ("attr", expr.attr, self._cls
                    if isinstance(expr.value, ast.Name) and
                    expr.value.id == "self" else None)
        if isinstance(expr, ast.Name) and expr.id.endswith(
                ("lock", "mu", "mutex", "_lk")):
            return ("name", expr.id, None)
        return None

    def visit_With(self, node):
        refs = []
        for item in node.items:
            ref = self._lock_ref(item.context_expr)
            if ref is not None and self._fn is not None:
                if self._held:
                    self._fn.nested.append(
                        (self._held[-1], ref, node.lineno))
                self._fn.acquires.append(ref)
                end = getattr(node, "end_lineno", node.lineno)
                self._fn.held_ranges.append((ref, node.lineno, end))
                refs.append(ref)
                self._held.append(ref)
        self.generic_visit(node)
        for _ in refs:
            self._held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        if self._fn is not None:
            callee = None
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                callee = ("method", self._cls, node.func.attr)
            elif isinstance(node.func, ast.Attribute):
                # obj.meth(): resolvable when the name is unique in the
                # package (e.g. guard.drain_binlog_retry under the store
                # lock — the edge the binlog retry protocol creates)
                callee = ("anymethod", None, node.func.attr)
            elif isinstance(node.func, ast.Name):
                callee = ("func", None, node.func.id)
            if callee is not None:
                self._fn.all_calls.append(callee)
                if self._held:
                    self._fn.held_calls.append(
                        (self._held[-1], callee, node.lineno))
        self.generic_visit(node)


@dataclass(frozen=True)
class LockFinding:
    module: str
    line: int
    msg: str


class LockGraph:
    """Package-wide aggregation; ``check`` yields LOCKORDER findings."""

    def __init__(self):
        self._files: list[_FileLockPass] = []

    def add_file(self, module: str, tree: ast.AST) -> None:
        self._files.append(_FileLockPass(module, tree))

    # -- resolution ---------------------------------------------------------

    def _resolve(self, fp: _FileLockPass, ref) -> LockId | None:
        kind, name, cls = ref
        defs = self._by_attr.get(name, ())
        if not defs:
            return None
        if kind == "attr" and cls is not None:
            for d in defs:
                if d.module == fp.module and d.cls == cls:
                    return d
        same_mod = [d for d in defs if d.module == fp.module]
        if len(same_mod) == 1:
            return same_mod[0]
        if len(defs) == 1:
            return defs[0]
        return None             # ambiguous: stay silent rather than guess

    # names too generic for unique-name call resolution (dict.get vs a
    # package-level get() would fabricate edges)
    _COMMON_NAMES = frozenset({
        "get", "put", "set", "add", "append", "appendleft", "pop", "popleft",
        "read", "write", "close", "clear", "update", "call", "wait",
        "remove", "release", "acquire", "observe", "send", "recv", "items",
        "keys", "values", "join", "start", "copy", "extend", "index",
        "insert", "sort", "split", "strip", "encode", "decode", "flush",
    })

    def _callee_infos(self, fp: _FileLockPass, callee) -> list:
        """Candidate callees.  obj.meth() resolves to EVERY same-named
        method in the package (unless the name is too generic): the caller
        cannot know which tier implementation it holds, so the may-acquire
        union over all of them is the sound answer (this is how the
        store-lock -> write_ops -> tier-lock edge is found)."""
        kind, cls, name = callee
        matches = []
        for f in self._funcs:
            if f.name != name:
                continue
            if kind == "method" and f.module == fp.module and f.cls == cls:
                return [f]
            if kind == "func" and f.module == fp.module and f.cls is None:
                return [f]
            matches.append(f)
        # unique names only: unioning multiply-defined names (leader /
        # advance / to_pylist across unrelated classes) fabricates edges
        # and false deadlock cycles.  Multiply-defined dispatch (write_ops
        # on the replicated vs remote tier) is a documented blind spot of
        # the static half — the runtime GuardedLock ranks cover it
        if kind == "anymethod" and len(matches) == 1 and \
                name not in self._COMMON_NAMES:
            return matches
        return []

    # -- analysis -----------------------------------------------------------

    def check(self, sync_sites: dict[str, list[int]]) -> tuple[
            list[LockFinding], list[str]]:
        """``sync_sites``: module -> lines of HOSTSYNC findings (pre-
        suppression: an intentional egress sync is still a stall under a
        lock).  Returns (findings, derived_order)."""
        self._by_attr: dict[str, list[LockId]] = {}
        self._funcs: list[_FuncInfo] = []
        for fp in self._files:
            for d in fp.defs:
                self._by_attr.setdefault(d.attr, []).append(d)
            self._funcs.extend(fp.funcs)

        # direct per-function acquisition summaries, then transitive closure
        # over the (same-class / same-module) call graph
        direct: dict[int, set[LockId]] = {}
        calls: dict[int, list] = {}
        fp_of: dict[int, _FileLockPass] = {}
        for fp in self._files:
            for f in fp.funcs:
                key = id(f)
                fp_of[key] = fp
                direct[key] = {lk for lk in
                               (self._resolve(fp, r) for r in f.acquires)
                               if lk is not None}
                calls[key] = [cand for c in f.all_calls
                              for cand in self._callee_infos(fp, c)]
        may: dict[int, set[LockId]] = {k: set(v) for k, v in direct.items()}
        for _ in range(len(self._funcs)):
            changed = False
            for k in may:
                for callee in calls[k]:
                    extra = may.get(id(callee), set()) - may[k]
                    if extra:
                        may[k] |= extra
                        changed = True
            if not changed:
                break

        # edges
        edges: dict[LockId, dict[LockId, tuple]] = {}

        def add_edge(a: LockId, b: LockId, module: str, line: int):
            if a == b:
                return      # re-entrant same-lock (RLock) — not an order
            edges.setdefault(a, {}).setdefault(b, (module, line))

        findings: list[LockFinding] = []
        for fp in self._files:
            for f in fp.funcs:
                for held_ref, ref, line in f.nested:
                    a, b = self._resolve(fp, held_ref), self._resolve(fp, ref)
                    if a is not None and b is not None:
                        add_edge(a, b, fp.module, line)
                for held_ref, callee, line in f.held_calls:
                    a = self._resolve(fp, held_ref)
                    if a is None:
                        continue
                    for target in self._callee_infos(fp, callee):
                        for b in may.get(id(target), ()):
                            add_edge(a, b, fp.module, line)
                # host syncs inside with-lock bodies
                lines = sync_sites.get(fp.module, ())
                for ref, lo, hi in f.held_ranges:
                    lk = self._resolve(fp, ref)
                    if lk is None:
                        continue
                    for ln in lines:
                        if lo < ln <= hi:
                            findings.append(LockFinding(
                                fp.module, ln,
                                f"host sync while holding {lk}: every "
                                "thread queued on the lock stalls for the "
                                "device round-trip — move the sync outside "
                                "the critical section"))

        # cycle detection (DFS), one finding per distinct cycle node-set
        seen_cycles: set[frozenset] = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color: dict[LockId, int] = {}
        stack: list[LockId] = []

        def dfs(u: LockId):
            color[u] = GRAY
            stack.append(u)
            for v, (module, line) in edges.get(u, {}).items():
                if color.get(v, WHITE) == WHITE:
                    dfs(v)
                elif color.get(v) == GRAY:
                    cyc = stack[stack.index(v):] + [v]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        findings.append(LockFinding(
                            module, line,
                            "lock order cycle: "
                            + " -> ".join(str(c) for c in cyc)
                            + " — threads taking these in opposite orders "
                            "deadlock"))
            stack.pop()
            color[u] = BLACK

        for node in list(edges):
            if color.get(node, WHITE) == WHITE:
                dfs(node)

        # derived order: topological over the edge graph (cycle-free part)
        order: list[str] = []
        mark: dict[LockId, int] = {}

        def topo(u: LockId):
            if mark.get(u):
                return
            mark[u] = 1
            for v in edges.get(u, {}):
                topo(v)
            order.append(str(u))

        for node in sorted(edges, key=str):
            topo(node)
        order.reverse()
        edge_list = sorted((str(a), str(b))
                           for a, m in edges.items() for b in m)
        return findings, order, edge_list
