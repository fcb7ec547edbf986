"""Test configuration.

Tests run on the CPU with an 8-device virtual mesh, so the multi-device
sharding logic is exercised without accelerators (SURVEY.md §4).  Set
CSDR_TEST_GPU=1 to run on the GPU instead; `chip_smoke.py` does so for the
tests marked `gpu`, which skip everywhere else.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if not os.environ.get("CSDR_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    # the CLI's main turns on the persistent compile cache; CPU test runs
    # keep their compilations to themselves
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU.  Decided here, when the
    test runs, never at import or collection."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")
    return jax.devices()[0]
