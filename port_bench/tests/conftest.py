"""CPU tests of the benchmark: `python -m pytest port_bench/tests -q`.
Tests marked `card` need the H100 and skip elsewhere (decided inside the
test, never at import)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the NVIDIA H100; skips without CUDA")
