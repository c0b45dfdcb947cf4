"""Per-file rule passes: taint-based HOSTSYNC plus the syntactic BAREEXC
and FAILPOINTHOT checks.

Scope model: a function is *hot* when it lives in a configured hot module
(the modules whose functions run the query's device work, ``LintConfig.
hot_paths``).  Hot scope arms the shape sinks (nonzero / unique / boolean
masks) and explicit synchronizes; the implicit conversion sinks
(``int()``/``np.asarray``/``.item()``/``.cpu()``) fire everywhere.
FAILPOINTHOT keeps the JAX package's reading of "traced": a hot module, or
a function decorated with ``jax.jit`` / ``pjit`` / ``pallas_call`` (eager
torch code has none, so only the hot modules apply to the port's own tree).
"""

from __future__ import annotations

import ast

from .taint import FunctionTaint, ModuleIndex


def _decorator_paths(fnode, mi: ModuleIndex):
    for d in fnode.decorator_list:
        yield d, mi.resolve(d.func if isinstance(d, ast.Call) else d)


def is_jit_decorated(fnode, mi: ModuleIndex) -> bool:
    for d, path in _decorator_paths(fnode, mi):
        if path is None:
            continue
        if "jax.jit" in path or path.endswith("pallas_call") or \
                path.endswith("pjit"):
            return True
        if path.endswith("partial") and isinstance(d, ast.Call) and d.args:
            first = mi.resolve(d.args[0])
            if first is not None and ("jax.jit" in first or
                                      first.endswith("pjit")):
                return True
    return False



def _is_failpoint_hit(path: str | None) -> bool:
    if path is None or "." not in path:
        return False
    head, _, last = path.rpartition(".")
    return last == "hit" and "failpoint" in head.lower()


def _is_enable_check(mi: ModuleIndex, expr: ast.expr) -> bool:
    """``failpoint.ENABLED`` (any alias/relative spelling)."""
    path = mi.resolve(expr)
    if path is None or "." not in path:
        return False
    head, _, last = path.rpartition(".")
    return last == "ENABLED" and "failpoint" in head.lower()


class _FailpointHot(ast.NodeVisitor):
    """FAILPOINTHOT: every ``failpoint.hit(...)`` site must (a) stay out of
    jit-traced scope — a host-side sleep/raise inside a trace fires at
    TRACE time and bakes nothing into the program — and (b) sit behind the
    module-level enable check (``if failpoint.ENABLED: ...`` or the inline
    ``failpoint.ENABLED and failpoint.hit(...)``), so a disabled build
    pays one bool read per site, never a registry lookup."""

    def __init__(self, mi: ModuleIndex, report, hot_module: bool):
        self.mi = mi
        self.report = report
        self.hot_module = hot_module
        self.guard_depth = 0
        self.traced_depth = 0

    def _check_call(self, node: ast.Call) -> None:
        if not _is_failpoint_hit(self.mi.resolve(node.func)):
            return
        if self.hot_module or self.traced_depth:
            self.report("FAILPOINTHOT", node,
                        "failpoint site inside jit-traced scope: the "
                        "sleep/raise fires at trace time, not run time — "
                        "move it to the dispatch layer")
        elif not self.guard_depth:
            self.report("FAILPOINTHOT", node,
                        "failpoint.hit not behind the module-level enable "
                        "check — guard with `if failpoint.ENABLED:` so a "
                        "disabled site costs one bool read")

    def visit_Call(self, node):
        self._check_call(node)
        self.generic_visit(node)

    def visit_BoolOp(self, node):
        # `failpoint.ENABLED and failpoint.hit(...)`: values after the
        # enable check short-circuit behind it — guarded
        if isinstance(node.op, ast.And) and node.values and \
                _is_enable_check(self.mi, node.values[0]):
            self.guard_depth += 1
            for v in node.values[1:]:
                self.visit(v)
            self.guard_depth -= 1
        else:
            self.generic_visit(node)

    def visit_If(self, node):
        if _is_enable_check(self.mi, node.test) or (
                isinstance(node.test, ast.BoolOp) and
                isinstance(node.test.op, ast.And) and node.test.values and
                _is_enable_check(self.mi, node.test.values[0])):
            self.visit(node.test)           # BoolOp handler guards the rest
            self.guard_depth += 1
            for n in node.body:
                self.visit(n)
            self.guard_depth -= 1
            for n in node.orelse:
                self.visit(n)
        else:
            self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # the guard is a RUNTIME check: an `if ENABLED:` around a def does
        # not guard the calls inside it, and traced-ness is per-function
        traced = is_jit_decorated(node, self.mi)
        prev_guard, self.guard_depth = self.guard_depth, 0
        if traced:
            self.traced_depth += 1
        self.generic_visit(node)
        if traced:
            self.traced_depth -= 1
        self.guard_depth = prev_guard

    visit_AsyncFunctionDef = visit_FunctionDef


class _BareExc(ast.NodeVisitor):
    """BAREEXC: handlers that swallow everything.  A bare ``except:`` (or
    ``except BaseException:``) traps KeyboardInterrupt/SystemExit; an
    ``except Exception: pass`` hides real failures from operators — narrow
    the type, or count it in metrics so the swallow is observable."""

    def __init__(self, mi: ModuleIndex, report):
        self.mi = mi
        self.report = report

    def visit_ExceptHandler(self, node):
        reraises = any(isinstance(n, ast.Raise)
                       for n in ast.walk(ast.Module(body=node.body,
                                                    type_ignores=[])))
        path = None if node.type is None else self.mi.resolve(node.type)
        broad = node.type is None or (
            path is not None and path.endswith("BaseException"))
        swallowed = len(node.body) == 1 and isinstance(
            node.body[0], (ast.Pass, ast.Continue))
        if broad and not reraises:
            # cleanup-then-reraise unwind blocks legitimately catch
            # BaseException; SWALLOWING one traps KeyboardInterrupt/SystemExit
            self.report("BAREEXC", node,
                        "swallowed bare/BaseException handler traps "
                        "KeyboardInterrupt/SystemExit — catch Exception "
                        "(or narrower), or re-raise")
        elif swallowed and path is not None and path.endswith("Exception"):
            self.report("BAREEXC", node,
                        "except Exception: pass swallows every failure "
                        "invisibly — narrow the type or count it in "
                        "metrics")
        self.generic_visit(node)


def lint_tree(tree: ast.AST, hot_module: bool, report) -> None:
    """Run all per-file rules over one parsed module.

    ``report(rule, node, msg)`` receives every raw finding (suppression is
    the runner's job)."""
    mi = ModuleIndex(tree)
    _BareExc(mi, report).visit(tree)
    _FailpointHot(mi, report, hot_module).visit(tree)

    def walk_defs(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                FunctionTaint(node, mi, hot_module, report).run()
            elif isinstance(node, ast.ClassDef):
                walk_defs(node.body)

    walk_defs(tree.body)
