"""ABC analytic BRDF fits.

JAX version of ``djb::abc`` (dj_brdf.h:513-535, 3502-3668):
D(h) = A / (1 + B (1 - cos theta_h))^C with a V-cavity min-style GAF
and exact unpolarized Fresnel from a scalar ior, fitted per MERL
material (parameters provided to the reference by Joel Kronander; the
table ships as data in ``models/data/material_tables.npz``).
"""

from __future__ import annotations

import functools
import importlib.resources

import jax.numpy as jnp
import numpy as np

from dj_brdf_tpu.core.math import normalize, dot, sat
from dj_brdf_tpu.core.pytree import pytree_dataclass
from dj_brdf_tpu.fresnel import Unpolarized


@functools.lru_cache(maxsize=None)
def _load_tables():
    path = importlib.resources.files("dj_brdf_tpu.models") / "data/material_tables.npz"
    with path.open("rb") as f:
        z = np.load(f)
        return {k: z[k] for k in z.files}


def material_names() -> list[str]:
    return [str(n) for n in _load_tables()["abc_names"]]


@pytree_dataclass
class ABC:
    """ABC BRDF for one material (or a broadcast batch)."""

    kd: jnp.ndarray   # (..., 3)
    a: jnp.ndarray    # (..., 3)
    b: jnp.ndarray    # (...,)
    c: jnp.ndarray    # (...,)
    ior: jnp.ndarray  # (...,)

    @staticmethod
    def from_name(name: str) -> "ABC":
        """(reference abc::abc, dj_brdf.h:3617-3629)."""
        t = _load_tables()
        names = [str(n) for n in t["abc_names"]]
        if name not in names:
            raise KeyError(f"no ABC parameters for {name!r}")
        row = names.index(name)
        return ABC(kd=jnp.asarray(t["abc_kd"][row], jnp.float32),
                   a=jnp.asarray(t["abc_a"][row], jnp.float32),
                   b=jnp.asarray(t["abc_b"][row], jnp.float32),
                   c=jnp.asarray(t["abc_c"][row], jnp.float32),
                   ior=jnp.asarray(t["abc_ior"][row], jnp.float32))

    @staticmethod
    def all_materials() -> "ABC":
        t = _load_tables()
        return ABC(kd=jnp.asarray(t["abc_kd"], jnp.float32),
                   a=jnp.asarray(t["abc_a"], jnp.float32),
                   b=jnp.asarray(t["abc_b"], jnp.float32),
                   c=jnp.asarray(t["abc_c"], jnp.float32),
                   ior=jnp.asarray(t["abc_ior"], jnp.float32))

    @property
    def fresnel(self):
        ior3 = jnp.broadcast_to(self.ior[..., None],
                                self.ior.shape + (3,))
        return Unpolarized(ior=ior3)

    def ndf(self, h):
        """(reference abc__ndf, dj_brdf.h:3608-3613). Formulated as
        exp(-C log1p(B(1-cos))) — accurate in f32 even for the extreme
        B values in the chrome/obsidian fits, and cheaper than pow."""
        tmp = 1.0 - h[..., 2:3]
        return self.a * jnp.exp(-self.c[..., None]
                                * jnp.log1p(self.b[..., None] * tmp))

    def gaf(self, h, i, o):
        """V-cavity-style min GAF (reference abc::gaf, dj_brdf.h:3649-3655)."""
        hi = jnp.where(dot(h, i) == 0.0, 1e-12, dot(h, i))
        ho = jnp.where(dot(h, o) == 0.0, 1e-12, dot(h, o))
        g1_i = jnp.minimum(1.0, 2.0 * (h[..., 2] * i[..., 2] / hi))
        g1_o = jnp.minimum(1.0, 2.0 * (h[..., 2] * o[..., 2] / ho))
        return jnp.minimum(g1_i, g1_o)

    def eval(self, i, o):
        """(reference abc::eval, dj_brdf.h:3633-3645)."""
        h = normalize(i + o, eps=1e-24)
        f = self.fresnel(sat(dot(i, h)))
        g = self.gaf(h, i, o)[..., None]
        d = self.ndf(h)
        iz = i[..., 2:3]
        oz = o[..., 2:3]
        above = (iz > 0.0) & (oz > 0.0)
        denom = jnp.where(above, jnp.pi * iz * oz, 1.0)
        val = self.kd / jnp.pi + (f * d * g) / denom
        return jnp.where(above, val, 0.0)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
