"""Shared test fixtures: a 4-device host platform + deterministic RNGs.

The XLA flag must be set before jax initializes its backend, i.e. at conftest
import time — pytest imports conftest before any test module, so in-process
tests can build 4-device meshes (``make_mesh_named("tiny")``,
test_dist_sharding) without a subprocess.  Subprocess-based tests set their
own XLA_FLAGS and are unaffected (the child overrides the inherited value).
"""
import os
import random

_FLAG = "--xla_force_host_platform_device_count=4"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _FLAG).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def host_devices():
    """The 4 host devices the XLA flag above pins (session-wide invariant)."""
    import jax
    devices = jax.devices()
    assert len(devices) >= 4, (
        "conftest must set --xla_force_host_platform_device_count=4 before "
        f"jax initializes; got {len(devices)} device(s)")
    return devices


@pytest.fixture(autouse=True)
def _seed_rngs():
    """Seed the global NumPy/stdlib RNGs per test; JAX randomness is keyed
    explicitly (PRNGKey) so per-test isolation needs no global state."""
    np.random.seed(0)
    random.seed(0)
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason on a host "
                   "without one (run them on the card: "
                   "PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py)")
