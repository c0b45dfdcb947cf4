"""Conservative intra-package call graph with thread-entry roots.

The lockset race detector (analysis/ownership.py) needs to know which
functions can run *concurrently*: an unguarded access to lock-owned state
only races when two threads can reach it.  This module answers that with a
package-wide call graph whose roots are the places threads are born:

- ``threading.Thread(target=X)`` — every background loop in the tree
  (telemetry poller, store tick/heartbeat, watchdogs, stream prefetcher,
  RPC serve threads) is spawned this way;
- RPC handler registration: ``srv.register(name, fn)`` when ``fn`` is a
  direct reference, plus the ``rpc_*`` naming convention used by
  server/store_server.py and server/meta_server.py (their registration is
  a dynamic ``getattr(self, "rpc_" + name)`` loop the resolver cannot see
  through) — handlers run on utils/net.py's thread-per-connection serve
  threads;
- loop-shaped entry points by name (``run`` / ``serve*`` / ``tick`` /
  ``poll`` / ``stage`` / ``*_loop``): session worker threads enter the
  engine through these (mysql_server spawns ``_serve`` per connection;
  BatchDispatcher.run is entered by many session threads at once), and the
  layer-crossing dispatch between them is too dynamic to resolve edges
  through.

Call edges use the same resolution a reader can do (and locks.py uses):
``self.meth()`` -> same class, bare ``fn()`` -> same module, ``obj.meth()``
-> the unique package-wide definition when the name is not generic.  The
*main* thread is an implicit root everywhere — any function may be entered
from a session/test thread — so "reachable from >= 2 roots" reduces to
"reachable from at least one spawned/handler/loop root".
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

# names too generic for unique-name resolution (mirrors locks.py: unioning
# dict.get with a package-level get() would fabricate reachability)
_COMMON_NAMES = frozenset({
    "get", "put", "set", "add", "append", "appendleft", "pop", "popleft",
    "read", "write", "close", "clear", "update", "call", "wait",
    "remove", "release", "acquire", "observe", "send", "recv", "items",
    "keys", "values", "join", "start", "copy", "extend", "index",
    "insert", "sort", "split", "strip", "encode", "decode", "flush",
})

# loop-shaped entry points: threads live here (see module docstring)
_LOOP_NAME_RE = re.compile(r"^(run|serve.*|tick|poll|stage|_serve.*)$")


def _is_entry_name(name: str) -> bool:
    return name.endswith("_loop") or bool(_LOOP_NAME_RE.match(name)) \
        or name.startswith("rpc_") or name.startswith("_handle")


@dataclass
class FuncNode:
    module: str
    cls: str | None          # enclosing class (kept across nested defs)
    name: str
    line: int
    # callee refs: ("method", cls, name) for self.m(), ("func", None, name)
    # for bare calls, ("anymethod", None, name) for obj.m()
    calls: list = field(default_factory=list)

    @property
    def key(self) -> tuple:
        return (self.module, self.cls, self.name, self.line)

    def __str__(self) -> str:
        scope = f"{self.cls}." if self.cls else ""
        return f"{self.module}:{scope}{self.name}"


class _FileCallPass(ast.NodeVisitor):
    """One file: function nodes, their callee refs, and root declarations
    (thread targets + direct handler registrations)."""

    def __init__(self, module: str, tree: ast.AST):
        self.module = module
        self.funcs: list[FuncNode] = []
        # (ref, kind, line): refs spawned as threads / registered handlers
        self.root_refs: list[tuple] = []
        self._cls: str | None = None
        self._fn: FuncNode | None = None
        self.visit(tree)

    def visit_ClassDef(self, node):
        prev, self._cls = self._cls, node.name
        self.generic_visit(node)
        self._cls = prev

    def visit_FunctionDef(self, node):
        prev = self._fn
        self._fn = FuncNode(self.module, self._cls, node.name, node.lineno)
        self.funcs.append(self._fn)
        self.generic_visit(node)
        self._fn = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def _ref(self, expr):
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                return ("method", self._cls, expr.attr)
            return ("anymethod", None, expr.attr)
        if isinstance(expr, ast.Name):
            return ("func", None, expr.id)
        return None

    def visit_Call(self, node):
        callee = self._ref(node.func)
        if callee is not None and self._fn is not None:
            self._fn.calls.append(callee)
        # threading.Thread(target=X) — keyword or 3rd positional arg
        fpath = self._dotted(node.func)
        if fpath is not None and fpath.endswith("Thread"):
            tgt = None
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = kw.value
            if tgt is None and len(node.args) >= 3:
                tgt = node.args[2]
            ref = self._ref(tgt) if tgt is not None else None
            if ref is not None:
                self.root_refs.append((ref, "thread", node.lineno))
        # srv.register("name", fn) with a direct function reference
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "register" and len(node.args) >= 2:
            ref = self._ref(node.args[1])
            if ref is not None:
                self.root_refs.append((ref, "rpc", node.lineno))
        self.generic_visit(node)

    @staticmethod
    def _dotted(expr) -> str | None:
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        parts.append(expr.id)
        return ".".join(reversed(parts))


class CallGraph:
    """Package-wide aggregation.  ``build()`` resolves edges and runs the
    root reachability BFS; afterwards ``spawned_roots_of`` answers which
    non-main roots reach a function."""

    def __init__(self):
        self._files: list[_FileCallPass] = []
        self._built = False

    def add_file(self, module: str, tree: ast.AST) -> None:
        self._files.append(_FileCallPass(module, tree))
        self._built = False

    # -- resolution ---------------------------------------------------------

    def _resolve(self, fp: _FileCallPass, ref) -> list[FuncNode]:
        kind, cls, name = ref
        exact, same_mod, anywhere = [], [], []
        for f in self._by_name.get(name, ()):
            if f.module == fp.module and f.cls == cls:
                exact.append(f)
            if f.module == fp.module:
                same_mod.append(f)
            anywhere.append(f)
        if kind == "method" and exact:
            return exact
        if kind == "func":
            top = [f for f in same_mod if f.cls is None]
            if top:
                return top
            # nested defs keep the enclosing class: target=loop inside a
            # method resolves to the unique same-module def of that name
            if len(same_mod) == 1:
                return same_mod
        if len(anywhere) == 1 and name not in _COMMON_NAMES:
            return anywhere
        return []

    # -- build --------------------------------------------------------------

    def build(self) -> None:
        if self._built:
            return
        self._by_name: dict[str, list[FuncNode]] = {}
        for fp in self._files:
            for f in fp.funcs:
                self._by_name.setdefault(f.name, []).append(f)

        self._edges: dict[tuple, list[tuple]] = {}
        for fp in self._files:
            for f in fp.funcs:
                out = self._edges.setdefault(f.key, [])
                for c in f.calls:
                    out.extend(t.key for t in self._resolve(fp, c))

        # roots: declared spawns/registrations + loop-shaped entry names
        self.roots: dict[tuple, str] = {}
        for fp in self._files:
            for ref, kind, line in fp.root_refs:
                for t in self._resolve(fp, ref):
                    self.roots.setdefault(t.key, f"{kind}:{t}")
            for f in fp.funcs:
                if _is_entry_name(f.name):
                    self.roots.setdefault(f.key, f"loop:{f}")

        # BFS per root; functions accumulate the set of root labels
        self._reach: dict[tuple, set] = {}
        for rkey, label in self.roots.items():
            stack = [rkey]
            while stack:
                k = stack.pop()
                labels = self._reach.setdefault(k, set())
                if label in labels:
                    continue
                labels.add(label)
                stack.extend(self._edges.get(k, ()))
        self._built = True

    # -- queries ------------------------------------------------------------

    def spawned_roots_of(self, module: str, cls: str | None,
                         name: str, line: int) -> set:
        """Root labels (threads / handlers / loop entries) reaching the
        function; the implicit main root is NOT included."""
        self.build()
        return self._reach.get((module, cls, name, line), set())

    def concurrent_classes(self) -> set:
        """(module, cls) pairs with at least one method reachable from a
        spawned root — their instances are shared across >= 2 roots (the
        spawned one plus the implicit main thread)."""
        self.build()
        out = set()
        for fp in self._files:
            for f in fp.funcs:
                if f.cls is not None and self._reach.get(f.key):
                    out.add((f.module, f.cls))
        return out
