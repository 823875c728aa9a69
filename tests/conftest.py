"""Test config. NOTE: no XLA_FLAGS device-count override here — smoke
tests must see the real single CPU device. Multi-device tests (wansync,
small-mesh dryrun) spawn subprocesses with their own env."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels have no CPU mode); such a test skips without one")
