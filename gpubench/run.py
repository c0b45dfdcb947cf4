"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Needs as many
CUDA cards as the cell asks for; without them it exits 2 and prints no
result.  The last line of standard output is the result's JSON object; the
numbers compared with the reference, each beside its limit, are the last
lines of standard error."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".gpubench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    # a crash of the process leaves every thread's Python stack on stderr
    faulthandler.enable()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0 or a.seconds <= 0:
        ap.error("--seed must be at least 0 and --seconds above 0")

    from gpubench.core.spec import load_cell

    cell = load_cell(a.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from gpubench.core.cell import run_cell

    out, rc = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    if out is not None:
        print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
