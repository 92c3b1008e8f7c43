"""The benchmark's own CPU tests (``python -m pytest portbench/tests -q -n 0``
from the root of the repository).  Tests that need a card carry the
``chip`` marker and skip, deciding inside the test, where CUDA is absent."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without CUDA")
