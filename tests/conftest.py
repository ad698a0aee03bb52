"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on the CPU backend's virtual devices;
`chip_smoke.py --four-cards` runs the same path on four GPUs.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repas_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root():
    if not REFERENCE.exists():
        pytest.skip("reference captures not mounted")
    return REFERENCE


@pytest.fixture()
def rng():
    # function-scoped on purpose: a session-scoped generator makes every
    # test's random data depend on which tests ran before it (the whole
    # suite becomes order-dependent and single-test runs see different
    # data than full-suite runs)
    return np.random.default_rng(0)
