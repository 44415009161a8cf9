"""Fresnel subsystem.

JAX version of the reference ``djb::fresnel`` namespace
(dj_brdf.h:148-207, impl 1251-1346). Each model is a pytree dataclass
with a pure ``__call__(cos_theta_d) -> (..., 3)`` so it can be traced,
vmapped, and differentiated — including w.r.t. its own parameters
(f0 / ior / spline control points are all learnable leaves).
"""

from __future__ import annotations

import jax.numpy as jnp

from dj_brdf_tpu.core import spline
from dj_brdf_tpu.core.pytree import pytree_dataclass


def ior_to_f0(ior):
    """Index of refraction -> normal-incidence reflectance
    (reference fresnel::ior_to_f0, dj_brdf.h:1255-1262)."""
    tmp = (ior - 1.0) / (ior + 1.0)
    return tmp * tmp


def f0_to_ior(f0):
    """Inverse of :func:`ior_to_f0` (reference dj_brdf.h:1272-1282)."""
    sqrt_f0 = jnp.sqrt(f0)
    return jnp.where(f0 == 1.0, 1.0, (1.0 + sqrt_f0) / (1.0 - jnp.minimum(sqrt_f0, 1.0 - 1e-7)))


@pytree_dataclass
class Ideal:
    """Perfect reflector: F = 1 (reference fresnel::ideal, dj_brdf.h:165-169)."""

    def __call__(self, cos_theta_d):
        c = jnp.asarray(cos_theta_d)
        return jnp.ones(c.shape + (3,), c.dtype)


@pytree_dataclass
class Unpolarized:
    """Exact unpolarized dielectric Fresnel (reference
    fresnel::unpolarized, dj_brdf.h:1292-1314). ``ior``: (..., 3)."""

    ior: jnp.ndarray

    def __call__(self, cos_theta_d):
        c = jnp.asarray(cos_theta_d)[..., None]
        n = self.ior
        g = jnp.sqrt(jnp.maximum(n * n + c * c - 1.0, 0.0))
        tmp1 = c * (g + c) - 1.0
        tmp2 = c * (g - c) + 1.0
        tmp3 = (tmp1 * tmp1) / (tmp2 * tmp2)
        tmp4 = ((g - c) * (g - c)) / ((g + c) * (g + c))
        return (0.5 * tmp4) * (1.0 + tmp3)


@pytree_dataclass
class Schlick:
    """Schlick's approximation (reference fresnel::schlick,
    dj_brdf.h:1316-1328). ``f0``: (..., 3)."""

    f0: jnp.ndarray

    def __call__(self, cos_theta_d):
        c1 = 1.0 - jnp.asarray(cos_theta_d)[..., None]
        c2 = c1 * c1
        c5 = c2 * c2 * c1
        return self.f0 + c5 * (1.0 - self.f0)


@pytree_dataclass
class SGDFresnel:
    """Two-coefficient Fresnel used by the SGD fits: F = f0 - c f1 +
    (1-c)^5 (1-f0) (reference fresnel::sgd, dj_brdf.h:1330-1336)."""

    f0: jnp.ndarray
    f1: jnp.ndarray

    def __call__(self, cos_theta_d):
        c = jnp.asarray(cos_theta_d)[..., None]
        return self.f0 - c * self.f1 + (1.0 - c) ** 5 * (1.0 - self.f0)


def conductor_fresnel(cos_theta, eta, k):
    """Exact unpolarized conductor Fresnel (the plugins' extra
    ``fresnelConductorExact`` factor, mitsuba/dj_beckmannconductor.cpp
    :325-326). ``eta``/``k``: (..., 3) complex ior. Returns (..., 3)."""
    c = jnp.asarray(cos_theta)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * e2 * k2, 0.0))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp + rs)


@pytree_dataclass
class Conductor:
    """Conductor Fresnel as a model object (eta, k per channel)."""

    eta: jnp.ndarray
    k: jnp.ndarray

    def __call__(self, cos_theta_d):
        return conductor_fresnel(cos_theta_d, self.eta, self.k)


@pytree_dataclass
class SplineFresnel:
    """Tabulated Fresnel over theta_d with u = 2 acos(c)/pi
    (reference fresnel::spline, dj_brdf.h:1338-1344). ``points``: (N, 3),
    differentiable table produced by the fitting pipeline."""

    points: jnp.ndarray

    def __call__(self, cos_theta_d):
        c = jnp.clip(jnp.asarray(cos_theta_d), -1.0, 1.0)
        u = 2.0 * jnp.arccos(c) / jnp.pi
        return spline.eval1d(self.points, u, wrap="edge")
