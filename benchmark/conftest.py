"""Test settings of the benchmark: its directory and the repository root on
the import path, and the ``card`` marker of tests that need a CUDA card
(each such test skips itself, inside the test, when none is present)."""

import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(BENCH), BENCH, os.path.join(BENCH, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips itself without one")
