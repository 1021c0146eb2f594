"""Shared test configuration.

Forces 8 host CPU devices (``--xla_force_host_platform_device_count=8``)
*before any jax import* so the SPMD engine tests (``tests/test_spmd.py``)
can build real multi-device meshes on accelerator-less CI hosts.  pytest
imports this conftest before collecting any test module, which is the only
reliable pre-jax hook; if some plugin or sitecustomize imported jax first,
the flag cannot take effect — the ``spmd_devices`` fixture then skips the
mesh tests instead of failing them.

The flag is additive: an operator-supplied XLA_FLAGS that already pins a
device count is left untouched.
"""
from __future__ import annotations

import os
import sys

SPMD_HOST_DEVICES = 8

if "jax" not in sys.modules:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + f" --xla_force_host_platform_device_count="
            f"{SPMD_HOST_DEVICES}").strip()

import pytest  # noqa: E402


@pytest.fixture
def spmd_devices() -> int:
    """Number of jax devices, skipping when the 8-device force didn't stick
    (jax initialized before this conftest could set XLA_FLAGS)."""
    import jax
    n = len(jax.devices())
    if n < SPMD_HOST_DEVICES:
        pytest.skip(f"needs {SPMD_HOST_DEVICES} forced host devices, "
                    f"found {n} (jax initialized before conftest?)")
    return n


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without one "
        "(run on the card: python -m pytest -q -m cuda tests/test_torch_cuda.py)")
