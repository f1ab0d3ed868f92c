"""The benchmark's own CPU tests: ``python -m pytest port_bench/tests -q`` from the
repository's root. Tests marked ``card`` need the CUDA device and skip without one,
deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA device; skips without one")
