"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count).  Checks that need the GPU are
marked ``gpu``, skip here, and run on the card through ``chip_smoke.py``.

The platform is pinned through jax.config, which takes effect even when jax
was imported before this file ran: to the CPU unless JAX_PLATFORMS names
others (``chip_smoke.py`` runs ``pytest -m gpu`` with ``cuda,cpu``).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test where there is none.  Decided
    inside the fixture, never at import, so every xdist worker collects the
    same tests."""
    try:
        devs = jax.devices("cuda")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devs[0]
