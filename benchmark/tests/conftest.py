"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` (CPU
here; ``-m cuda`` on the card). They import the benchmark's modules as the
harness does, from the benchmark's folder."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (sm_90); skips elsewhere")
