"""Microfacet slope-distribution parameters.

JAX version of ``djb::microfacet::params`` (dj_brdf.h:212-243,
impl 1348-1506). The canonical storage is the PDF parameterization
(alpha_x, alpha_y, rho, tx_n, ty_n): Gaussian-slope scales, slope
correlation, and the non-central mean-normal slope offset. The
elliptic (a1, a2, phi_a) parameterization converts to/from it with
pure functions, so gradients flow through either view.

All fields are arrays broadcastable against sample batch shapes, so a
single `MicrofacetParams` can hold per-pixel textured roughness
(the reference's textured alpha1/alpha2/alphaAngle path,
mitsuba/dj_brdf.cpp:353-357) with no code change.
"""

from __future__ import annotations

import jax.numpy as jnp

from dj_brdf_tpu.core.math import vec3, normalize
from dj_brdf_tpu.core.pytree import pytree_dataclass


def ellipse_to_pdfparams(a1, a2, phi_a):
    """(a1, a2, phi_a) ellipse -> (ax, ay, rho) PDF parameters
    (reference ellipse_to_pdfparams, dj_brdf.h:1355-1371)."""
    cos_phi_a = jnp.cos(phi_a)
    sin_phi_a = jnp.sin(phi_a)
    cos_2phi_a = 2.0 * cos_phi_a * cos_phi_a - 1.0
    a1_sqr = a1 * a1
    a2_sqr = a2 * a2
    tmp1 = a1_sqr + a2_sqr
    tmp2 = a1_sqr - a2_sqr
    ax = jnp.sqrt(0.5 * (tmp1 + tmp2 * cos_2phi_a))
    ay = jnp.sqrt(0.5 * (tmp1 - tmp2 * cos_2phi_a))
    rho = (a2_sqr - a1_sqr) * cos_phi_a * sin_phi_a / (ax * ay)
    return ax, ay, rho


def pdfparams_to_ellipse(ax, ay, rho):
    """(ax, ay, rho) -> (a1, a2, phi_a) principal-axes form
    (reference pdfparams_to_ellipse, dj_brdf.h:1378-1393)."""
    ax_sqr = ax * ax
    ay_sqr = ay * ay
    cov = rho * ax * ay * 2.0
    tmp1 = ax_sqr + ay_sqr
    tmp2 = ax_sqr - ay_sqr
    tmp3 = jnp.sqrt(tmp2 * tmp2 + cov * cov)
    a1 = jnp.sqrt(0.5 * (tmp1 + tmp3))
    a2 = jnp.sqrt(jnp.maximum(0.5 * (tmp1 - tmp3), 0.0))
    safe_cov = jnp.where(cov == 0.0, 1.0, cov)
    phi_a = jnp.where(cov == 0.0, 0.0, jnp.arctan((ax_sqr - ay_sqr - tmp3) / safe_cov))
    return a1, a2, phi_a


@pytree_dataclass
class MicrofacetParams:
    """PDF parameters of an elliptic, possibly non-central slope
    distribution. Leaves broadcast over batch shapes."""

    ax: jnp.ndarray
    ay: jnp.ndarray
    rho: jnp.ndarray
    txn: jnp.ndarray
    tyn: jnp.ndarray

    # -- constructors -------------------------------------------------
    @staticmethod
    def standard():
        """Unit-roughness isotropic (reference params::standard,
        dj_brdf.h:1412-1415)."""
        return MicrofacetParams.isotropic(1.0)

    @staticmethod
    def isotropic(a):
        return MicrofacetParams.elliptic(a, a, 0.0)

    @staticmethod
    def elliptic(a1, a2, phi_a=0.0, txn=0.0, tyn=0.0):
        ax, ay, rho = ellipse_to_pdfparams(
            jnp.asarray(a1, jnp.result_type(float, a1)),
            jnp.asarray(a2, jnp.result_type(float, a2)),
            jnp.asarray(phi_a, jnp.result_type(float, phi_a)))
        return MicrofacetParams(ax=ax, ay=ay, rho=rho,
                                txn=jnp.asarray(txn, ax.dtype),
                                tyn=jnp.asarray(tyn, ax.dtype))

    @staticmethod
    def pdfparams(ax, ay, rho=0.0, txn=0.0, tyn=0.0):
        dt = jnp.result_type(float, ax, ay)
        return MicrofacetParams(ax=jnp.asarray(ax, dt), ay=jnp.asarray(ay, dt),
                                rho=jnp.asarray(rho, dt),
                                txn=jnp.asarray(txn, dt), tyn=jnp.asarray(tyn, dt))

    @staticmethod
    def from_normal(n, ax=1.0, ay=1.0, rho=0.0):
        """Set the location from a mean normal (reference
        params::set_location(vec3), dj_brdf.h:1444-1449)."""
        txn = -n[..., 0] / n[..., 2]
        tyn = -n[..., 1] / n[..., 2]
        return MicrofacetParams.pdfparams(ax, ay, rho, txn, tyn)

    # -- derived quantities -------------------------------------------
    @property
    def sqrt_one_minus_rho_sqr(self):
        return jnp.sqrt(jnp.maximum(1.0 - self.rho * self.rho, 1e-24))

    @property
    def mean_normal(self):
        """Unit mean normal n = normalize(-txn, -tyn, 1) (reference
        params::set_location, dj_brdf.h:1437-1442)."""
        one = jnp.ones_like(self.txn)
        return normalize(vec3(-self.txn, -self.tyn, one))

    def ellipse(self):
        """(a1, a2, phi_a) view."""
        return pdfparams_to_ellipse(self.ax, self.ay, self.rho)
