"""Lint runner: file discovery, rule execution, suppression handling.

Suppression channels (all explicit, all greppable):

- inline, same line:        ``x = int(flag)  # tpulint: disable=HOSTSYNC``
- inline, next line:        ``# tpulint: disable-next-line=HOSTSYNC,BAREEXC``
- whole file:               ``# tpulint: disable-file=BAREEXC`` (top of file)
- suppression file:         one ``path RULE line-or-qualname-or-*`` entry
  per line (see tools/lint_suppressions.txt) — the reviewed registry of
  *intentional* sync points (egress materialization, host-side caches).

The syntax is the JAX package's (``tpulint``), so one fixture parses the
same under both linters.  ``run_lint`` returns the surviving violations;
exit-code policy belongs to the CLI (tools/lint.py).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .callgraph import CallGraph
from .locks import LockGraph
from .ownership import OwnershipGraph
from .rules import lint_tree

_INLINE_RE = re.compile(
    r"#\s*tpulint:\s*(disable|disable-next-line|disable-file)="
    r"([A-Z]+(?:\s*,\s*[A-Z]+)*)")

# the JAX package's RETRACE, TRACERLEAK, SPANINJIT, METRICINJIT,
# PROGRESSINJIT and DONATED are about jit traces and donated buffers, which
# eager torch has neither of; RETRACE's branch and loop sinks are HOSTSYNC
RULES = ("HOSTSYNC", "LOCKORDER", "BAREEXC", "FAILPOINTHOT", "GUARDEDBY",
         "LOCKHELDBLOCK", "ATOMICITY")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str               # repo-relative, forward slashes
    line: int
    col: int
    msg: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.msg}"


@dataclass
class LintConfig:
    """``hot_paths``: package-relative prefixes of the modules that run the
    query's device work (the JAX package's jit-traced modules) — functions
    there get the hot-scope sinks."""
    hot_paths: tuple = ("ops/", "parallel/", "column/", "exec/executor.py",
                        "expr/compile.py", "expr/builtins_ext.py",
                        "expr/builtins_ext2.py")
    package: str = "baikaldb_tpu_torch"
    suppression_file: str | None = None
    rules: tuple = RULES

    def is_hot(self, relpath: str) -> bool:
        norm = relpath.replace(os.sep, "/")
        marker = f"{self.package}/"
        idx = norm.find(marker)
        sub = norm[idx + len(marker):] if idx >= 0 else norm
        return any(sub.startswith(h) for h in self.hot_paths)


@dataclass
class Suppressions:
    # (path, rule) -> list of scopes; scope is "*", an int line, or a name
    entries: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Suppressions":
        sup = cls()
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) not in (2, 3):
                    raise ValueError(
                        f"{path}: bad suppression line {line!r} "
                        "(want: <path> <RULE> [line|qualname|*])")
                fpath, rule = parts[0], parts[1]
                scope: object = parts[2] if len(parts) == 3 else "*"
                if isinstance(scope, str) and scope.isdigit():
                    scope = int(scope)
                sup.entries.setdefault(
                    (fpath.replace(os.sep, "/"), rule), []).append(scope)
        return sup

    def matches(self, v: Violation, func_at_line) -> bool:
        for scope in self.entries.get((v.path, v.rule), ()):
            if scope == "*":
                return True
            if isinstance(scope, int) and scope == v.line:
                return True
            if isinstance(scope, str) and func_at_line(v.line) == scope:
                return True
        return False


def _inline_suppressed(src_lines: list[str], v: Violation) -> bool:
    def rules_on(line_no: int, directives: tuple) -> set[str]:
        if not (1 <= line_no <= len(src_lines)):
            return set()
        m = _INLINE_RE.search(src_lines[line_no - 1])
        if m and m.group(1) in directives:
            return {r.strip() for r in m.group(2).split(",")}
        return set()

    if v.rule in rules_on(v.line, ("disable",)):
        return True
    if v.rule in rules_on(v.line - 1, ("disable-next-line",)):
        return True
    for ln in src_lines[:5]:
        m = _INLINE_RE.search(ln)
        if m and m.group(1) == "disable-file" and \
                v.rule in {r.strip() for r in m.group(2).split(",")}:
            return True
    return False


def _collect_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def _relpath(path: str, root: str | None) -> str:
    rel = os.path.relpath(path, root) if root else path
    return rel.replace(os.sep, "/").lstrip("./")


class _FuncIndex:
    """line -> enclosing function name (for qualname-scoped suppressions)."""

    def __init__(self, tree: ast.AST):
        self.spans: list[tuple[int, int, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.spans.append((node.lineno,
                                   getattr(node, "end_lineno", node.lineno),
                                   node.name))

    def at(self, line: int) -> str | None:
        best = None
        for lo, hi, name in self.spans:
            if lo <= line <= hi and (best is None or lo > best[0]):
                best = (lo, name)
        return best[1] if best else None


def run_lint(paths: list[str], config: LintConfig | None = None,
             root: str | None = None) -> list[Violation]:
    """Lint ``paths`` (files/dirs); returns surviving violations sorted by
    (path, line).  ``root`` anchors the repo-relative paths used for
    reporting and suppression matching (defaults to cwd)."""
    config = config or LintConfig()
    sup = Suppressions.load(config.suppression_file) \
        if config.suppression_file else Suppressions()
    files = _collect_files(paths)
    graph = LockGraph()
    owners = OwnershipGraph()
    callgraph = CallGraph()
    raw: list[Violation] = []
    sources: dict[str, list[str]] = {}
    findex: dict[str, _FuncIndex] = {}
    sync_sites: dict[str, list[int]] = {}

    for path in files:
        rel = _relpath(path, root)
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            raw.append(Violation("HOSTSYNC", rel, e.lineno or 0, 0,
                                 f"file does not parse: {e.msg}"))
            continue
        sources[rel] = src.splitlines()
        findex[rel] = _FuncIndex(tree)
        seen: set[tuple] = set()

        def report(rule, node, msg, rel=rel):
            line = getattr(node, "lineno", 0)
            col = getattr(node, "col_offset", 0)
            key = (rule, line, col)
            if key in seen:
                return
            seen.add(key)
            raw.append(Violation(rule, rel, line, col, msg))
            if rule == "HOSTSYNC":
                sync_sites.setdefault(rel, []).append(line)

        lint_tree(tree, config.is_hot(rel), report)
        graph.add_file(rel, tree)
        owners.add_file(rel, tree)
        callgraph.add_file(rel, tree)

    lock_findings, lock_order, lock_edges = graph.check(sync_sites)
    for lf in lock_findings:
        raw.append(Violation("LOCKORDER", lf.module, lf.line, 0, lf.msg))
    owner_findings, ownership = owners.check(callgraph)
    for of in owner_findings:
        raw.append(Violation(of.rule, of.module, of.line, 0, of.msg))
    # introspection for tests/docs: the derived order + raw A->B edges +
    # the inferred guarded-by map the runtime witness arms from
    run_lint.last_lock_order = lock_order
    run_lint.last_lock_edges = lock_edges
    run_lint.last_ownership = ownership

    out = []
    for v in raw:
        if v.rule not in config.rules:
            continue
        lines = sources.get(v.path, [])
        if lines and _inline_suppressed(lines, v):
            continue
        fi = findex.get(v.path)
        if sup.matches(v, fi.at if fi else lambda _ln: None):
            continue
        out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out


run_lint.last_lock_order = []
run_lint.last_lock_edges = []
run_lint.last_ownership = {}
