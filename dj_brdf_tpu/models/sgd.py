"""Shifted-Gamma-Distribution analytic BRDF fits.

JAX version of ``djb::sgd`` (dj_brdf.h:480-511, 3309-3500):
an analytic microfacet-style model with per-channel SGD NDF and
exponential-form shadowing, fitted to each of the 100 MERL materials
(parameters after Bagher, Soler, Holzschuch, EGSR 2012; the table is
shipped as data in ``models/data/material_tables.npz``).

All 100 materials live in one (100, 12, 3) device array, so a whole
material batch evaluates as one fused kernel (vmap over the material
axis) — the device replacement for the reference's name->row pointer.
"""

from __future__ import annotations

import functools
import importlib.resources

import jax.numpy as jnp
import numpy as np

from dj_brdf_tpu.core.math import normalize, dot, sat
from dj_brdf_tpu.core.pytree import pytree_dataclass
from dj_brdf_tpu.fresnel import SGDFresnel

_FIELDS = {name: idx for idx, name in enumerate(
    ["rhoD", "rhoS", "alpha", "p", "f0", "f1", "kap", "lambda_",
     "c", "k", "theta0", "error"])}


@functools.lru_cache(maxsize=None)
def _load_tables():
    path = importlib.resources.files("dj_brdf_tpu.models") / "data/material_tables.npz"
    with path.open("rb") as f:
        z = np.load(f)
        return {k: z[k] for k in z.files}


def material_names() -> list[str]:
    return [str(n) for n in _load_tables()["sgd_names"]]


@pytree_dataclass
class SGD:
    """SGD BRDF for one material (or a batch: leading dims broadcast).
    ``params``: (..., 12, 3) rows of the fit table."""

    params: jnp.ndarray

    @staticmethod
    def from_name(name: str) -> "SGD":
        """Name->row lookup on host (reference sgd::sgd, dj_brdf.h:3435-3450);
        accepts either the MERL name or the alternate name column."""
        t = _load_tables()
        names = [str(n) for n in t["sgd_names"]]
        other = [str(n) for n in t["sgd_other_names"]]
        if name in names:
            row = names.index(name)
        elif name in other:
            row = other.index(name)
        else:
            raise KeyError(f"no SGD parameters for {name!r}")
        return SGD(params=jnp.asarray(t["sgd_params"][row], dtype=jnp.float32))

    @staticmethod
    def all_materials() -> "SGD":
        """All 100 materials stacked on a leading axis."""
        return SGD(params=jnp.asarray(_load_tables()["sgd_params"], jnp.float32))

    def _p(self, field):
        return self.params[..., _FIELDS[field], :]

    @property
    def fresnel(self):
        return SGDFresnel(f0=self._p("f0"), f1=self._p("f1"))

    def ndf(self, h):
        """Per-channel SGD NDF (reference sgd__ndf, dj_brdf.h:3424-3431)."""
        c2 = jnp.maximum(h[..., 2:3] ** 2, 1e-12)
        t2 = (1.0 - c2) / c2
        alpha = self._p("alpha")
        ax = alpha + t2 / alpha
        kap, p = self._p("kap"), self._p("p")
        return kap * jnp.exp(-ax) / (jnp.pi * jnp.power(ax, p) * c2 * c2)

    def g1(self, k):
        """Exponential-form monodirectional shadowing (reference
        sgd__g1, dj_brdf.h:3415-3421)."""
        theta = jnp.arccos(jnp.clip(k[..., 2:3], -1.0, 1.0))
        tmp1 = jnp.maximum(0.0, theta - self._p("theta0"))
        tmp2 = 1.0 - jnp.exp(self._p("c") * jnp.power(tmp1, self._p("k")))
        tmp3 = 1.0 + self._p("lambda_") * tmp2
        return jnp.clip(tmp3, 0.0, 1.0)

    def gaf(self, h, i, o):
        return self.g1(i) * self.g1(o)

    def eval(self, i, o):
        """(reference sgd::eval, dj_brdf.h:3454-3468)."""
        h = normalize(i + o, eps=1e-24)
        ks = self._p("rhoS")
        kd = self._p("rhoD")
        f = self.fresnel(sat(dot(i, h)))
        g = self.gaf(h, i, o)
        d = self.ndf(h)
        iz = i[..., 2:3]
        oz = o[..., 2:3]
        denom = jnp.where((iz > 0.0) & (oz > 0.0), iz * oz, 1.0)
        val = (kd + ks * (f * d * g) / denom) / jnp.pi
        return jnp.where((iz > 0.0) & (oz > 0.0), val, 0.0)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
