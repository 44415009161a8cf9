"""Renderer front-end materials — the plugin layer.

The reference exposes its models to renderers through six Mitsuba BSDF
plugins (mitsuba/dj_brdf.cpp, dj_beckmannconductor.cpp, dj_merl.cpp,
dj_utia.cpp, dj_sgd.cpp, dj_abc.cpp). Here each becomes a pytree
material with a uniform (evalp, sample, pdf, evalp_is) surface that a
path tracer or our sphere renderer consumes:

* :class:`MicrofacetMaterial` — dj_brdf: analytic distribution +
  Fresnel + textured-capable params (dj_brdf.cpp:342-439).
* :class:`MeasuredMaterial` — dj_merl/dj_sgd/dj_abc: measured/analytic
  eval with a fitted-GGX-proxy VNDF sampler; weight = evalp/pdf
  (dj_merl.cpp:56-101, dj_sgd.cpp:80-108, dj_abc.cpp:81-109).
* :class:`CosineMaterial` — dj_utia: plain cosine-hemisphere sampling
  (dj_utia.cpp:66-99; the reference brdf base defaults,
  dj_brdf.h:830-845).
* ``lean.filtered.FilteredBeckmannMaterial`` — dj_beckmannconductor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dj_brdf_tpu.core.math import cosine_hemisphere_sample, dot, normalize
from dj_brdf_tpu.core.pytree import pytree_dataclass
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX
from dj_brdf_tpu.microfacet.params import MicrofacetParams


@pytree_dataclass
class MicrofacetMaterial:
    """Analytic microfacet BSDF (the dj_brdf plugin): any distribution
    + Fresnel + params; params leaves may be per-pixel textures."""

    dist: object
    fres: object
    params: MicrofacetParams

    def evalp(self, i, o):
        return mf.evalp(self.dist, self.fres, self.params, i, o)

    def sample(self, u1, u2, o):
        return mf.sample(self.dist, self.params, u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(self.dist, self.params, i, o)

    def _fused_pvec(self):
        """(8,) pvec for the fused SoA samplers, or None when the
        material shape doesn't qualify (textured params, non-Schlick
        Fresnel, other distributions)."""
        from dj_brdf_tpu import fresnel as _fres
        from dj_brdf_tpu.microfacet.ndf import (GGX as _GGX,
                                                Beckmann as _Beck)
        p = self.params
        if not isinstance(self.fres, _fres.Schlick):
            return None
        if not (type(self.dist) is _Beck or isinstance(self.dist, _GGX)):
            return None
        leaves = (p.ax, p.ay, p.rho, p.txn, p.tyn)
        if any(getattr(x, "ndim", 0) != 0 for x in leaves):
            return None
        f0 = jnp.asarray(self.fres.f0)
        if f0.shape != (3,):
            return None
        return jnp.stack([jnp.asarray(x, jnp.float32) for x in leaves]
                         + [f0[0], f0[1], f0[2]])

    def evalp_is(self, u1, u2, o):
        """Sample + weight. Uniform GGX/Beckmann + Schlick materials
        route through the fused SoA kernels (ops/soa.py), which skip
        the layered path's repeated warps; other shapes fall back to
        the general path. Both paths zero weight and pdf for receivers
        below the mean-normal horizon (where the reference emits an
        arbitrary "up" sample, dj_brdf.h:1677-1678), so a material
        renders identically whichever path dispatches it."""
        pvec = self._fused_pvec()
        if pvec is not None:
            from dj_brdf_tpu.microfacet.ndf import (Beckmann as _Beck,
                                                    GGXSphericalCaps as _Caps)
            from dj_brdf_tpu.ops import soa as _soa
            ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
            if type(self.dist) is _Beck:
                out = _soa.beckmann_evalp_is_soa(pvec, u1, u2, ox, oy, oz)
            else:
                out = _soa.ggx_evalp_is_soa(pvec, u1, u2, ox, oy, oz,
                                            caps=isinstance(self.dist, _Caps))
            wr, wg, wb, ix, iy, iz, pdf = out
            return (jnp.stack([wr, wg, wb], -1),
                    jnp.stack([ix, iy, iz], -1), pdf)
        w, i, pdf = mf.evalp_is(self.dist, self.fres, self.params, u1, u2, o)
        # align the fallback with the fused kernels at the edge lanes:
        # warped-receiver horizon check c(o) <= 0
        p = self.params
        c_o = o[..., 2] - o[..., 0] * p.txn - o[..., 1] * p.tyn
        bad = c_o <= 0.0
        return (jnp.where(bad[..., None], 0.0, w), i,
                jnp.where(bad, 0.0, pdf))


def _fetch_rows(packed, h, w, uu, vv):
    """Nearest-texel row gather of a flat (H*W, k) packed texture at
    normalized uv (the sample_texture convention; differentiable
    w.r.t. the texels)."""
    return jnp.take(packed, texel_index(h, w, uu, vv), axis=0)


def texel_index(h, w, uu, vv):
    """Flat nearest-texel index at normalized uv."""
    yi = jnp.clip((vv * h).astype(jnp.int32), 0, h - 1)
    xi = jnp.clip((uu * w).astype(jnp.int32), 0, w - 1)
    return yi * w + xi


class TextureProvider(NamedTuple):
    """A textured material's per-hit parameter source for the fused
    path tracer: ``packed`` (rows, k) — the texture rows, possibly a
    whole mip pyramid flattened level-major — fetched at indices from
    ``index(uu, vv, lod)``; ``assemble(row) -> (8, N)`` turns a
    fetched row into the kernels' pvec. Exposing the packed table
    (rather than a fetch closure) lets the render loop COMBINE both
    materials' tables into one and serve sphere and floor lanes —
    disjoint populations — with a single gather per bounce.

    ``neutral``: a (k,) row of safe values substituted on the OTHER
    material's lanes before assembly, so garbage cross-material bytes
    never reach assemble's math (whose reverse-mode would turn
    0-cotangent x inf-derivative into NaN). ``wants_lod``: True when
    ``index`` uses the per-lane ray-cone LOD (mip pyramids); the
    render loop only computes footprints when some provider asks."""
    packed: object
    h: int
    w: int
    assemble: object
    neutral: object
    index: object
    wants_lod: bool = False


@pytree_dataclass
class TexturedMicrofacetMaterial:
    """The dj_brdf plugin's textured-roughness front-end for the path
    tracer: alpha1/alpha2/alphaAngle are evaluated per shading point
    *inside the bounce loop* (mitsuba/dj_brdf.cpp:353-357 fetches its
    textures per-hit inside whatever Mitsuba integrator runs), so the
    material composes with any transport — direct light, multi-bounce,
    envmap MIS.

    Each alpha leaf is a scalar or an (H, W) texture; all texture
    leaves must share one shape so the per-hit fetch is ONE packed row
    gather. Rendering goes through the fused SoA kernels, which take
    per-ray (8, N) parameter vectors (ops/soa.py); gradients flow into
    the texture leaves (inverse rendering of roughness maps)."""

    dist: object                 # GGX-family or Beckmann
    fres: object                 # Schlick
    alpha1: jnp.ndarray
    alpha2: jnp.ndarray
    alpha_angle: jnp.ndarray

    def _fused_family(self):
        from dj_brdf_tpu import fresnel as _fres
        from dj_brdf_tpu.microfacet.ndf import (GGX as _GGX,
                                                Beckmann as _Beck,
                                                GGXSphericalCaps as _Caps)
        if not isinstance(self.fres, _fres.Schlick):
            return None
        if not (type(self.dist) is _Beck or isinstance(self.dist, _GGX)):
            return None
        fam = "beck" if type(self.dist) is _Beck else "ggx"
        return fam, isinstance(self.dist, _Caps)

    def pvec_provider(self) -> "TextureProvider":
        """Per-hit parameter provider: the textured alphas pack into
        one (H*W, k) table (built here, once per trace, so it stays
        out of the bounce scan); ``assemble`` converts a fetched row's
        elliptic frame to PDF parameters and appends the Schlick f0."""
        leaves = [("a1", self.alpha1), ("a2", self.alpha2),
                  ("ang", self.alpha_angle)]
        texs = [(k, jnp.asarray(v, jnp.float32)) for k, v in leaves
                if getattr(v, "ndim", 0) == 2]
        shapes = {v.shape for _, v in texs}
        if len(shapes) > 1:
            raise ValueError(
                f"textured alpha maps must share one shape, got {shapes}")
        packed = cols = h = w = None
        if texs:
            h, w = texs[0][1].shape
            packed = jnp.stack([v for _, v in texs], -1).reshape(-1,
                                                                 len(texs))
            cols = {k: i for i, (k, _) in enumerate(texs)}
        f0 = jnp.asarray(self.fres.f0, jnp.float32)

        def assemble(row):
            def get(key, leaf):
                if cols is not None and key in cols:
                    return row[..., cols[key]]
                return jnp.asarray(leaf, jnp.float32)

            p = MicrofacetParams.elliptic(get("a1", self.alpha1),
                                          get("a2", self.alpha2),
                                          get("ang", self.alpha_angle))
            from dj_brdf_tpu.render.pathtrace import _stack_pvec
            return _stack_pvec(p.ax, p.ay, p.rho, p.txn, p.tyn,
                               f0[0], f0[1], f0[2])

        neutral = (jnp.full((len(texs),), 0.3, jnp.float32)
                   if texs else None)

        def index(uu, vv, lod=None):
            return texel_index(h, w, uu, vv)

        return TextureProvider(packed=packed, h=h, w=w,
                               assemble=assemble, neutral=neutral,
                               index=index)


@pytree_dataclass
class UVMappedMaterial:
    """Textured roughness over ANY distribution — including tabular
    NDFs — for the path tracer's generic loop: the dj_brdf plugin's
    textured alpha1/alpha2/alphaAngle front end with
    distribution="tabular" (mitsuba/dj_brdf.cpp:208-233, 353-357),
    where the texture modulates the extracted table's unit base
    roughness per shading point under any integrator.

    The bounce loop calls :meth:`at_uv` with the per-hit uv; the
    result is a plain MicrofacetMaterial whose parameter leaves are
    per-lane arrays (MicrofacetParams broadcasts), evaluated through
    the layered path — slower than the fused analytic-family kernels
    (use TexturedMicrofacetMaterial for GGX/Beckmann) but fully
    general. Gradients flow into the texture leaves."""

    dist: object                 # any distribution (Tabular included)
    fres: object
    alpha1: jnp.ndarray          # scalar or (H, W)
    alpha2: jnp.ndarray
    alpha_angle: jnp.ndarray

    def at_uv(self, uu, vv):
        def fetch(leaf):
            leaf = jnp.asarray(leaf, jnp.float32)
            if leaf.ndim != 2:
                return leaf
            h, w = leaf.shape
            return jnp.take(leaf.reshape(-1),
                            texel_index(h, w, uu, vv))

        params = MicrofacetParams.elliptic(fetch(self.alpha1),
                                           fetch(self.alpha2),
                                           fetch(self.alpha_angle))
        return MicrofacetMaterial(dist=self.dist, fres=self.fres,
                                  params=params)


@pytree_dataclass
class MeasuredMaterial:
    """Measured (or analytic-fit) eval + importance sampling through a
    fitted GGX proxy — the dj_merl render pattern."""

    model: object                 # anything with .evalp(i, o)
    proxy_params: MicrofacetParams
    proxy_dist: object

    @staticmethod
    def from_merl(table, res: int = 90):
        """Scene-load-time fit, like the dj_merl ctor
        (mitsuba/dj_merl.cpp:29-33): ``tabular(merl, res, shadow=False)``
        then ``fit_ggx_parameters``."""
        from dj_brdf_tpu.fit import moments, tabular
        from dj_brdf_tpu.models.merl import Merl
        m = Merl(table=table)
        tab, _ = tabular.build_tabular(m, res, shadow=False)
        return MeasuredMaterial(model=m,
                                proxy_params=moments.fit_ggx_parameters(tab),
                                proxy_dist=GGX())

    @staticmethod
    def from_model(model, res: int = 90):
        """dj_sgd/dj_abc pattern: proxy from tabular(model, res)
        (mitsuba/dj_sgd.cpp:29-31)."""
        from dj_brdf_tpu.fit import moments, tabular
        tab, _ = tabular.build_tabular(model, res)
        return MeasuredMaterial(model=model,
                                proxy_params=moments.fit_ggx_parameters(tab),
                                proxy_dist=GGX())

    def evalp(self, i, o):
        return self.model.evalp(i, o)

    def sample(self, u1, u2, o):
        return mf.sample(self.proxy_dist, self.proxy_params, u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(self.proxy_dist, self.proxy_params, i, o)

    def evalp_is(self, u1, u2, o):
        """weight = evalp/pdf (dj_merl.cpp:86-99)."""
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        safe = jnp.maximum(p, 1e-12)
        ok = (p > 0.0) & (i[..., 2] > 0.0)
        w = jnp.where(ok[..., None], self.evalp(i, o) / safe[..., None], 0.0)
        return w, i, jnp.where(ok, p, 0.0)


@pytree_dataclass
class CosineMaterial:
    """Cosine-hemisphere sampling around any model (dj_utia pattern;
    reference defaults dj_brdf.h:830-845)."""

    model: object

    def evalp(self, i, o):
        return self.model.evalp(i, o)

    def sample(self, u1, u2, o):
        return cosine_hemisphere_sample(u1, u2)

    def pdf(self, i, o):
        return jnp.maximum(i[..., 2], 0.0) / jnp.pi

    def evalp_is(self, u1, u2, o):
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        safe = jnp.maximum(p, 1e-12)
        ok = p > 0.0
        w = jnp.where(ok[..., None], self.evalp(i, o) / safe[..., None], 0.0)
        return w, i, p


@pytree_dataclass
class ConductorWrap:
    """Exact conductor Fresnel multiplied on top of any material —
    the dj_brdf plugin's Mitsuba-Fresnel path
    (mitsuba/dj_brdf.cpp:366, 430)."""

    inner: object
    eta: jnp.ndarray
    k: jnp.ndarray

    def _cond(self, i, o):
        from dj_brdf_tpu.fresnel import conductor_fresnel
        h = normalize(i + o, eps=1e-24)
        return conductor_fresnel(jnp.clip(dot(o, h), 0.0, 1.0),
                                 self.eta, self.k)

    def evalp(self, i, o):
        return self.inner.evalp(i, o) * self._cond(i, o)

    def sample(self, u1, u2, o):
        return self.inner.sample(u1, u2, o)

    def pdf(self, i, o):
        return self.inner.pdf(i, o)

    def evalp_is(self, u1, u2, o):
        i = self.sample(u1, u2, o)
        p = self.pdf(i, o)
        safe = jnp.maximum(p, 1e-12)
        ok = (p > 0.0) & (i[..., 2] > 0.0)
        w = jnp.where(ok[..., None], self.evalp(i, o) / safe[..., None], 0.0)
        return w, i, jnp.where(ok, p, 0.0)


def eval_hd(model, h, d):
    """Evaluate any material in half/diff coordinates (reference
    brdf::eval_hd, dj_brdf.h:795-801)."""
    from dj_brdf_tpu.core.math import hd_to_io
    i, o = hd_to_io(h, d)
    return model.evalp(i, o) / jnp.maximum(i[..., 2:3], 1e-12)
