"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding code is validated without accelerators by forcing
the host CPU platform to expose 8 devices (the pattern recommended for
distributed CI in SURVEY.md section 4). Must run before jax is imported.
Every test reference matmul runs at full f32 (`highest`), the precision
named once here.

Tests that only the card can run carry `@pytest.mark.gpu` and request the
`gpu_device` fixture, which skips them here; on the card run them with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_RESOURCES = "/root/reference/resources"


@pytest.fixture(scope="session")
def coarse1_mesh():
    from eigenpinns_tpu.geometry import load_mesh

    return load_mesh(os.path.join(REFERENCE_RESOURCES, "coarse_1.obj"))


@pytest.fixture(scope="session")
def bunny_mesh():
    from eigenpinns_tpu.geometry import load_mesh

    return load_mesh(os.path.join(REFERENCE_RESOURCES, "bunny.obj"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none (decided when the
    test runs, never at collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform})")
    return dev
