"""Test-session bootstrap: fall back to the degenerate hypothesis shim.

The real ``hypothesis`` (requirements-dev.txt) is preferred; on a clean
environment the shim in ``_hypothesis_compat`` keeps the suite collecting
and running with fixed seeded examples instead of failing at import time.
"""
import pathlib
import sys

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import _hypothesis_compat
    _hypothesis_compat.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test when there is none")
