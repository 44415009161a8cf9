"""Sharded spherical integrals.

Replaces the reference's serial direction loops (sigma integral
dj_brdf.h:2348-2386, furnace test tests/nrm_utia.cpp:20-51) with
quadrature grids sharded across the mesh data axis; the reduction is a
plain sum, so XLA turns the final combine into a psum across devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.parallel.mesh import DATA_AXIS


def furnace_integral(evalp_fn, o, n_theta: int = 64, n_phi: int = 256,
                     mesh=None):
    """White-furnace energy integral int evalp(i, o) sin(theta) di for a
    batch of outgoing directions ``o`` (..., 3). Matches the quadrature
    of tests/nrm_utia.cpp:20-51. With a mesh, the o-batch shards over
    the data axis."""
    u1 = jnp.arange(n_theta, dtype=jnp.float32) / n_theta
    u2 = jnp.arange(n_phi, dtype=jnp.float32) / n_phi
    theta = u1 * jnp.pi / 2.0
    phi = u2 * jnp.pi * 2.0
    T, Ph = jnp.meshgrid(theta, phi, indexing="ij")
    i = from_spherical(T, Ph)  # (n_theta, n_phi, 3)
    dw = (jnp.pi / 2.0 / n_theta) * (jnp.pi * 2.0 / n_phi)

    def one(o_single):
        vals = evalp_fn(i, jnp.broadcast_to(o_single, i.shape))
        return jnp.sum(vals * jnp.sin(T)[..., None], axis=(0, 1)) * dw

    # chunk the o-batch with lax.map so the (n_o x n_theta x n_phi)
    # integrand never materializes whole, and jit the entire sweep
    def sweep(flat_o):
        return jax.lax.map(one, flat_o, batch_size=64)

    flat_o = o.reshape(-1, 3)
    if mesh is not None:
        fn = jax.jit(sweep, in_shardings=NamedSharding(mesh, P(DATA_AXIS)),
                     out_shardings=NamedSharding(mesh, P(DATA_AXIS)))
    else:
        fn = jax.jit(sweep)
    out = fn(flat_o)
    return out.reshape(o.shape[:-1] + (3,))


def furnace_test(evalp_fn, n_out_theta: int = 64, n_out_phi: int = 256,
                 mesh=None, tol: float = 1.0):
    """Energy-conservation check over an outgoing grid (the machine-
    checkable pass/fail of the reference, tests/nrm_utia.cpp:53-69).
    Returns (ok, max_integral)."""
    u1 = jnp.arange(n_out_theta, dtype=jnp.float32) / n_out_theta
    u2 = jnp.arange(n_out_phi, dtype=jnp.float32) / n_out_phi
    T, Ph = jnp.meshgrid(u1 * jnp.pi / 2.0, u2 * jnp.pi * 2.0, indexing="ij")
    o = from_spherical(T, Ph)
    vals = furnace_integral(evalp_fn, o, mesh=mesh)
    max_val = jnp.max(vals)
    return bool(max_val <= tol), float(max_val)
