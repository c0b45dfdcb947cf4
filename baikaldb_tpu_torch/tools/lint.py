"""The port's lint CLI — host-sync hygiene and lock-discipline lint.

Usage:
    python -m baikaldb_tpu_torch.tools.lint baikaldb_tpu_torch/   # the tree
    python -m baikaldb_tpu_torch.tools.lint --diff-only    # git-changed files
    python -m baikaldb_tpu_torch.tools.lint --list-rules
    python -m baikaldb_tpu_torch.tools.lint --lock-order baikaldb_tpu_torch/

Exit code 0 when clean, 1 when violations survive suppression, 2 on usage
errors.  The suppression registry lives in
baikaldb_tpu_torch/tools/lint_suppressions.txt (each entry commented with
WHY the sync/exception is intentional); inline ``# tpulint: disable=RULE``
comments work too.  tests/test_torch_lint.py runs the same entry point, so
the tree stays at zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ..analysis import LintConfig, run_lint
from ..analysis.lint import RULES

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
DEFAULT_SUPPRESSIONS = os.path.join(_PKG, "tools", "lint_suppressions.txt")

_RULE_HELP = {
    "HOSTSYNC": "silent device->host reads (int()/.item()/.cpu()/.tolist(),"
                " branches on tensors, data-dependent shapes in hot modules)",
    "LOCKORDER": "lock acquisition cycles; host syncs under a held lock",
    "BAREEXC": "swallow-all exception handlers",
    "FAILPOINTHOT": "failpoint sites in hot modules, or not behind the "
                    "module-level `if failpoint.ENABLED:` guard",
    "GUARDEDBY": "read/write of lock-owned state without the owning lock "
                 "on a >= 2-thread path (lockset race detection)",
    "LOCKHELDBLOCK": "RPC / device sync / time.sleep / file I/O while "
                     "holding a lock — every queued thread inherits the "
                     "stall",
    "ATOMICITY": "check-then-act on lock-owned state with the lock "
                 "dropped between check and act",
}


def _git_changed_files() -> list[str]:
    """Changed .py files vs HEAD (staged + unstaged + untracked) — the
    edit-loop fast path."""
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"], cwd=_REPO, check=True,
            capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"lint: --diff-only needs git: {e}", file=sys.stderr)
        raise SystemExit(2)
    files = []
    for line in out.splitlines():
        if len(line) < 4 or line[0] == "D" or line[1] == "D":
            continue
        path = line[3:].split(" -> ")[-1].strip().strip('"')
        if path.endswith(".py") and os.path.exists(os.path.join(_REPO, path)):
            files.append(os.path.join(_REPO, path))
    return files


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m baikaldb_tpu_torch.tools.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--diff-only", action="store_true",
                    help="lint only files changed vs git HEAD")
    ap.add_argument("--suppressions", default=DEFAULT_SUPPRESSIONS,
                    help="suppression registry (default: %(default)s)")
    ap.add_argument("--no-suppressions", action="store_true",
                    help="report raw findings, ignoring every suppression "
                         "channel except inline comments")
    ap.add_argument("--rules", default=",".join(RULES),
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--lock-order", action="store_true",
                    help="print the statically-derived lock order and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON document with "
                         "per-violation rule/file/line/col/detail plus "
                         "summary counts (stable ordering — CI can diff "
                         "two runs textually); exit codes unchanged")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULES:
            print(f"{r:<13} {_RULE_HELP.get(r, '')}")
        return 0

    rules = tuple(r.strip().upper() for r in args.rules.split(",") if r)
    bad = [r for r in rules if r not in RULES]
    if bad:
        print(f"lint: unknown rule(s): {', '.join(bad)}", file=sys.stderr)
        return 2

    if args.diff_only:
        paths = _git_changed_files()
        if not paths:
            print("lint: no changed python files")
            return 0
    else:
        paths = args.paths or [_PKG]

    sup = None if args.no_suppressions else (
        args.suppressions if os.path.exists(args.suppressions) else None)
    config = LintConfig(suppression_file=sup, rules=rules)
    violations = run_lint(paths, config, root=_REPO)

    if args.lock_order:
        for name in run_lint.last_lock_order:
            print(name)
        return 0

    counts: dict[str, int] = {}
    for v in violations:
        counts[v.rule] = counts.get(v.rule, 0) + 1

    if args.json:
        import json
        # run_lint's (path, line, col, rule) sort + sort_keys makes the
        # document byte-stable for a given tree: lint-state diffs are
        # plain textual diffs of two runs
        doc = {"violations": [{"rule": v.rule, "file": v.path,
                               "line": v.line, "col": v.col,
                               "detail": v.msg} for v in violations],
               "counts": {r: counts[r] for r in sorted(counts)},
               "total": len(violations)}
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if violations else 0

    if not args.quiet:
        for v in violations:
            print(v.render())
    detail = ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
    print(f"lint: {len(violations)} violation(s)"
          + (f" ({detail})" if detail else ""))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
