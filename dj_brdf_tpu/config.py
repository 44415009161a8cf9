"""Global configuration.

Mirrors the reference's compile-time switches (dj_brdf.h:44-51):
``DJB_USE_DOUBLE_PRECISION`` -> :func:`use_x64`, ``DJB_EPSILON`` ->
:data:`EPSILON`.
"""

from __future__ import annotations

import logging
import os

import jax
import jax.numpy as jnp

logger = logging.getLogger("dj_brdf_tpu")

#: Numerical epsilon used for horizon / degeneracy clamps
#: (reference DJB_EPSILON, dj_brdf.h:49-51).
EPSILON = 1e-4

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path, since the path is part of the cache's key.
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is set here; otherwise the cache lives in
    :data:`DEFAULT_COMPILE_CACHE` (``<repo>/.jax_cache``)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


def use_x64(enable: bool = True) -> None:
    """Enable float64 globally (reference DJB_USE_DOUBLE_PRECISION)."""
    jax.config.update("jax_enable_x64", enable)


def default_float() -> jnp.dtype:
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
