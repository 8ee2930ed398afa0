"""Test configuration.

The sharding tests run on an 8-device virtual CPU mesh: the flag below must
land before JAX initializes a backend (lazily, so conftest time is fine).
Run the suite on the CPU with ``JAX_PLATFORMS=cpu``.  Tests that need a GPU
are marked ``gpu`` and take the ``gpu`` fixture, which skips them elsewhere.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


def cpu_mesh_devices(n: int = 8):
    """Return n CPU devices or None (callers skip)."""
    import jax

    try:
        devs = jax.devices("cpu")
    except RuntimeError:
        return None
    return devs[:n] if len(devs) >= n else None
