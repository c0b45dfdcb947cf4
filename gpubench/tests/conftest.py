"""The benchmark's own tests: ``python -m pytest -q -p no:cacheprovider
gpubench/tests`` from the root of the checkout.  They run on the CPU at
small sizes; tests marked ``cuda`` need the card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where torch.cuda.is_available() is False")
