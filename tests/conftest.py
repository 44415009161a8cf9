"""Test configuration.

Tests run on the CPU with 8 virtual devices so sharding/mesh tests work
in a single process; this also keeps jit compile times in the suite
tolerable and deterministic. The GPU paths run compiled through
``python chip_smoke.py`` (and ``--four`` for the mesh paths).

The platform is forced through jax.config before any backend use, so
the suite stays on the CPU even where a GPU plugin is installed.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
