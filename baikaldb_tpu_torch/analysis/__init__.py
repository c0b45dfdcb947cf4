"""The analysis plane: static lint and runtime guards of the port.

An eager torch engine lives or dies by invariants a Python reader cannot
see locally:

- no silent device->host reads on the hot path (HOSTSYNC) — on the card
  every ``int(t)`` / ``.item()`` / ``.cpu()`` / branch on a tensor blocks
  the host until the device catches up;
- a cycle-free, sync-free lock discipline (LOCKORDER, LOCKHELDBLOCK), with
  lock-owned state touched only under its lock (GUARDEDBY, ATOMICITY);

plus BAREEXC for swallow-all exception handlers and FAILPOINTHOT for
unguarded failpoint sites.  ``lint.run_lint`` drives the per-file rules
(rules.py, over the taint engine in taint.py) and the package-wide passes
(locks.py, ownership.py over callgraph.py); ``tools/lint.py`` is the CLI
and ``tests/test_torch_lint.py`` pins the tree at zero violations.
``runtime.py`` is the dynamic half (``debug_guards``): the sync guard on
the card, the ranked ``GuardedLock`` and the lockset witness.
"""

from .lint import LintConfig, Violation, run_lint  # noqa: F401
