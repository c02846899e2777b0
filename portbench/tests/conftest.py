"""pytest settings of the benchmark's own tests: the repository root on the
path, and the ``cuda`` marker for tests that need the card (they skip
themselves where there is none)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU with CUDA; the test skips itself where there is none')
