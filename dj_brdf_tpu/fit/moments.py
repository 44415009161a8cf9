"""Moment-based roughness extraction from tabulated NDFs.

JAX version of the reference's direct parametric conversions:
``tabular::fit_beckmann_parameters`` (dj_brdf.h:3133-3158),
``tabular::fit_ggx_parameters`` (3160-3184), and the anisotropic
5-moment variants (3186-3307). The quadrature grids and weights match
the reference exactly so fitted alphas agree with the C++ oracle.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from dj_brdf_tpu.microfacet.params import MicrofacetParams


def _log_alpha(name, alpha):
    """DJB_LOG parity: the reference prints each fitted alpha
    (dj_brdf.h:3154, 3180, 3237). Skipped under trace (vmap/jit)."""
    import jax
    import logging
    from dj_brdf_tpu.config import logger
    if (not isinstance(alpha, jax.core.Tracer)
            and logger.isEnabledFor(logging.DEBUG)):
        # float() is a blocking device readback — only pay it when
        # debug logging is actually on
        logger.debug("%s: alpha = %.9g", name, float(alpha))


def _ft(dist):
    """Working precision: follow the distribution's tables
    (DJB_USE_DOUBLE_PRECISION parity), f32 for analytic dists."""
    t = getattr(dist, "p22", None)
    return t.dtype.type if t is not None else np.float32


def fit_beckmann_parameters(dist) -> MicrofacetParams:
    """alpha = sqrt(2 E[r^2 cos^2 phi]) (dj_brdf.h:3133-3158)."""
    ft = _ft(dist)
    ntheta = 128
    dtheta = np.pi / ntheta
    u = jnp.arange(ntheta, dtype=ft) / ntheta
    theta_h = u * u * ft(np.pi * 0.5)
    cos_h = jnp.cos(theta_h)
    r_h = jnp.tan(theta_h)
    p22_r = dist.p22_radial(r_h * r_h)
    nint = jnp.sum((u * r_h ** 3 * p22_r) / (cos_h * cos_h))
    nint = nint * dtheta * np.pi  # int_0^2pi cos^2 = pi
    alpha = jnp.sqrt(2.0 * nint)
    _log_alpha("fit_beckmann_parameters", alpha)  # dj_brdf.h:3154
    return MicrofacetParams.isotropic(alpha)


def fit_ggx_parameters(dist) -> MicrofacetParams:
    """alpha = E[r |cos phi|]-style first moment (dj_brdf.h:3160-3184)."""
    ft = _ft(dist)
    ntheta = 128
    dtheta = np.pi / ntheta
    u = jnp.arange(ntheta, dtype=ft) / ntheta
    theta_h = u * u * ft(np.pi * 0.5)
    cos_h = jnp.cos(theta_h)
    r_h = jnp.tan(theta_h)
    p22_r = dist.p22_radial(r_h * r_h)
    nint = jnp.sum((u * r_h ** 2 * p22_r) / (cos_h * cos_h))
    alpha = nint * dtheta * 4.0  # int_0^2pi |cos| = 4
    _log_alpha("fit_ggx_parameters", alpha)  # dj_brdf.h:3180
    return MicrofacetParams.isotropic(alpha)


def _aniso_moments(dist, ggx: bool):
    """Shared 5-moment quadrature over the standard slope PDF
    (dj_brdf.h:3186-3307)."""
    ft = _ft(dist)
    ntheta, nphi = 128, 512
    dtheta = np.sqrt(np.pi * 0.5) / ntheta
    dphi = 2.0 * np.pi / nphi

    tj = jnp.arange(nphi, dtype=ft) / nphi
    phi = tj * ft(2.0 * np.pi)
    ti = jnp.arange(ntheta, dtype=ft) / ntheta
    theta = ti * ft(np.sqrt(np.pi * 0.5))
    theta_sqr = theta * theta

    T2, P = jnp.meshgrid(theta_sqr, phi)      # (nphi, ntheta)
    Tw = jnp.meshgrid(theta, phi)[0]
    p22 = dist.p22_std_theta_phi(T2, P)
    tan_t = jnp.tan(T2)
    cos_t = jnp.cos(T2)
    w = Tw * p22 * tan_t / (cos_t * cos_t)

    cos_p = jnp.cos(P)
    sin_p = jnp.sin(P)
    e1 = -tan_t * cos_p
    e2 = -tan_t * sin_p
    if ggx:
        e3 = jnp.abs(e1)
        e4 = jnp.abs(e2)
        e5 = jnp.zeros_like(e1)
    else:
        e3 = tan_t ** 2 * cos_p ** 2
        e4 = tan_t ** 2 * sin_p ** 2
        e5 = tan_t ** 2 * cos_p * sin_p
    scale = 2.0 * dtheta * dphi
    # jnp scalars (NOT float() host syncs): the fits stay jittable,
    # vmappable over table batches, and differentiable
    return [jnp.sum(w * e) * scale for e in (e1, e2, e3, e4, e5)]


def fit_beckmann_parameters_anisotropic(dist) -> MicrofacetParams:
    """(dj_brdf.h:3186-3247). Pure device computation: composes with
    jit/vmap over a stack of tables and grads flow to the table."""
    m = _aniso_moments(dist, ggx=False)
    mux, muy = m[0], m[1]
    ax = jnp.sqrt(2.0 * (m[2] - mux * mux))
    ay = jnp.sqrt(2.0 * (m[3] - muy * muy))
    rho = 2.0 * (m[4] - mux * muy) / (ax * ay)
    return MicrofacetParams.pdfparams(ax, ay, rho, mux, muy)


def fit_ggx_parameters_anisotropic(dist) -> MicrofacetParams:
    """(dj_brdf.h:3249-3307; rho fixed to 0 as in the reference TODO)."""
    m = _aniso_moments(dist, ggx=True)
    mux, muy = m[0], m[1]
    ax = jnp.sqrt(jnp.maximum(m[2] * m[2] - mux * mux, 0.0))
    ay = jnp.sqrt(jnp.maximum(m[3] * m[3] - muy * muy, 0.0))
    return MicrofacetParams.pdfparams(ax, ay, 0.0, mux, muy)
