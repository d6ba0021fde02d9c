import os
import sys

import pytest

# Tests see exactly one device unless a test spawns its own subprocess
# with XLA_FLAGS (the dry-run needs 512 placeholder devices; smoke tests
# must NOT).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow", action="store_true", default=False,
        help="run tests marked slow (10^6-node scale tier)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: excluded from tier-1; enable with --run-slow")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="needs --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
