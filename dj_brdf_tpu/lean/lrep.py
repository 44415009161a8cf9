"""LEAN linear representation of Beckmann slope statistics.

JAX version of ``djb::beckmann::lrep`` (dj_brdf.h:330-356, impl
1959-2051): five slope moments (E1,E2 means; E3,E4 second moments; E5
joint moment) that are closed under addition and scalar scaling with
covariance-correct operators — the algebra behind LEAN/LEADR filtered
normal mapping. All fields broadcast, so an Lrep can be a whole
texture/mip pyramid; mip reduction is a plain mean of Lrep leaves.
"""

from __future__ import annotations

import jax.numpy as jnp

from dj_brdf_tpu.core.pytree import pytree_dataclass
from dj_brdf_tpu.microfacet.params import MicrofacetParams


@pytree_dataclass
class Lrep:
    E1: jnp.ndarray
    E2: jnp.ndarray
    E3: jnp.ndarray
    E4: jnp.ndarray
    E5: jnp.ndarray

    @staticmethod
    def identity(shape=(), dtype=jnp.float32):
        z = jnp.zeros(shape, dtype)
        o = jnp.ones(shape, dtype)
        return Lrep(E1=z, E2=z, E3=o, E4=o, E5=z)

    def __add__(self, r: "Lrep") -> "Lrep":
        """Combine two independent slope distributions (reference
        lrep::operator+, dj_brdf.h:1992-1999): second moments pick up
        the cross terms of the sum of independent variables."""
        return Lrep(E1=self.E1 + r.E1,
                    E2=self.E2 + r.E2,
                    E3=self.E3 + r.E3 + 2.0 * self.E1 * r.E1,
                    E4=self.E4 + r.E4 + 2.0 * self.E2 * r.E2,
                    E5=self.E5 + r.E5 + self.E1 * r.E2 + self.E2 * r.E1)

    def __mul__(self, sc) -> "Lrep":
        """Scale slopes by sc (reference lrep::operator*,
        dj_brdf.h:2001-2009): first moments scale linearly, second
        moments quadratically."""
        sc = jnp.asarray(sc)
        sc2 = sc * sc
        return Lrep(E1=self.E1 * sc, E2=self.E2 * sc,
                    E3=self.E3 * sc2, E4=self.E4 * sc2, E5=self.E5 * sc2)

    __rmul__ = __mul__

    def shear(self, tx, ty) -> "Lrep":
        """Add a deterministic slope offset (reference lrep::shear,
        dj_brdf.h:2035-2042)."""
        return Lrep(E1=self.E1 + tx, E2=self.E2 + ty,
                    E3=self.E3 + tx * tx, E4=self.E4 + ty * ty,
                    E5=self.E5 + tx * ty)

    def scale_xy(self, x, y) -> "Lrep":
        """Anisotropic slope scaling (reference lrep::scale,
        dj_brdf.h:2044-2051)."""
        return Lrep(E1=self.E1 * x, E2=self.E2 * y,
                    E3=self.E3 * x * x, E4=self.E4 * y * y,
                    E5=self.E5 * x * y)

    def reparameterize(self, dudx, dvdx, dudy, dvdy) -> "Lrep":
        """Linear change of the slope-plane basis. Declared but left
        unimplemented in the reference (dj_brdf.h:346-347); provided
        here as the natural pushforward of the moments under the
        Jacobian [[dudx, dvdx], [dudy, dvdy]]."""
        e1 = dudx * self.E1 + dvdx * self.E2
        e2 = dudy * self.E1 + dvdy * self.E2
        e3 = (dudx * dudx * self.E3 + dvdx * dvdx * self.E4
              + 2.0 * dudx * dvdx * self.E5)
        e4 = (dudy * dudy * self.E3 + dvdy * dvdy * self.E4
              + 2.0 * dudy * dvdy * self.E5)
        e5 = (dudx * dudy * self.E3 + dvdx * dvdy * self.E4
              + (dudx * dvdy + dvdx * dudy) * self.E5)
        return Lrep(E1=e1, E2=e2, E3=e3, E4=e4, E5=e5)

    def mean(self, axis=None) -> "Lrep":
        """Average a batch of lreps — the LEAN mip/footprint filter
        (moments of a mixture are the means of the moments)."""
        return Lrep(E1=jnp.mean(self.E1, axis=axis),
                    E2=jnp.mean(self.E2, axis=axis),
                    E3=jnp.mean(self.E3, axis=axis),
                    E4=jnp.mean(self.E4, axis=axis),
                    E5=jnp.mean(self.E5, axis=axis))


def params_to_lrep(params: MicrofacetParams) -> Lrep:
    """(reference beckmann::params_to_lrep, dj_brdf.h:1965-1974)."""
    return Lrep(E1=params.txn,
                E2=params.tyn,
                E3=0.5 * params.ax * params.ax + params.txn * params.txn,
                E4=0.5 * params.ay * params.ay + params.tyn * params.tyn,
                E5=0.5 * params.rho * params.ax * params.ay
                   + params.txn * params.tyn)


def lrep_to_params(lrep: Lrep) -> MicrofacetParams:
    """(reference beckmann::lrep_to_params, dj_brdf.h:1976-1990),
    including the validity clamps alpha >= 1e-5 and |rho| <= 0.99."""
    txn = lrep.E1
    tyn = lrep.E2
    tmp1 = jnp.maximum(0.0, lrep.E3 - lrep.E1 * lrep.E1)
    tmp2 = jnp.maximum(0.0, lrep.E4 - lrep.E2 * lrep.E2)
    ax = jnp.maximum(1e-5, jnp.sqrt(2.0 * tmp1))
    ay = jnp.maximum(1e-5, jnp.sqrt(2.0 * tmp2))
    rho = 2.0 * (lrep.E5 - lrep.E1 * lrep.E2) / (ax * ay)
    rho = jnp.clip(rho, -0.99, 0.99)
    return MicrofacetParams(ax=ax, ay=ay, rho=rho, txn=txn, tyn=tyn)
