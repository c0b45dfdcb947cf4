"""Seeded chaos runner: kill / partition / latency scenarios with
exactly-once assertions, on the port.

    python -m baikaldb_tpu_torch.tools.chaos_run --seed 7              # all, on the card
    python -m baikaldb_tpu_torch.tools.chaos_run --seed 7 --device cpu
    python -m baikaldb_tpu_torch.tools.chaos_run --seed 7 --scenario kill_leader --writes 40

Prints ONE JSON line per scenario: the fault schedule actually injected,
a sha256 digest of the deterministic final state (fleet-plane scenarios
replay bit-identically: same seed -> same schedule, same digest, and the
same as the JAX package's), the assertion results, and observed
retry/dedupe/latency counters.  Exit 0 iff every scenario's invariants
held.  The scenarios' engines run on ``--device`` (default: the CUDA card;
without one and without ``--device cpu`` every scenario that builds a
``Database`` reports the missing card as its error).

Determinism contract: run the same seed twice and diff the
``fault_schedule`` and ``state_digest`` fields — identical for the
fleet-plane scenarios (kill_leader, partition, split_chaos,
migrate_chaos, snapshot_chaos, cdc_chaos); for rpc_chaos (real
threads/sockets) the digest covers the final rows, which must still be
identical, while the crash entry's store id is timing-informational.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from ..chaos.scenarios import SCENARIOS, run_scenario

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1,
                    help="chaos seed: fault schedules are a pure function "
                         "of it")
    ap.add_argument("--scenario", default="all",
                    choices=["all", *sorted(SCENARIOS)])
    ap.add_argument("--writes", type=int, default=None,
                    help="client writes per scenario (scenario default "
                         "when omitted)")
    ap.add_argument("--device", default=None,
                    help="torch device of the scenarios' engines "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    ok = True
    for name in names:
        kw = {} if args.writes is None else {"writes": args.writes}
        result = run_scenario(name, args.seed, device=args.device, **kw)
        ok = ok and result["ok"]
        print(json.dumps(result, default=str), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
