"""Filtered (LEAN/LEADR) render path.

JAX version of the ``dj_beckmannconductor`` Mitsuba plugin's
per-shading-point parameter assembly
(mitsuba/dj_beckmannconductor.cpp:280-428): fetch the (possibly
mip-filtered) LEAN moments, remove the storage bias, optionally fall
back to naive mip statistics, scale by the displacement amplitude,
combine with the base-roughness lrep, and convert back to microfacet
parameters. Everything is per-pixel batched, so a whole G-buffer of
footprints resolves in one fused kernel.
"""

from __future__ import annotations

import jax.numpy as jnp

from dj_brdf_tpu.core.math import dot, normalize
from dj_brdf_tpu.core.pytree import pytree_dataclass, static_field
from dj_brdf_tpu.lean.lrep import Lrep, lrep_to_params, params_to_lrep
from dj_brdf_tpu.lean.maps import unbias, LEAN_BIAS
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams


def filtered_params(lean: Lrep, base_params: MicrofacetParams,
                    dmap_scale=1.0, lean_filtering: bool = True,
                    biased: bool = False) -> MicrofacetParams:
    """Combine fetched LEAN moments with base roughness (reference
    eval/pdf/sample preamble, dj_beckmannconductor.cpp:291-314)."""
    if biased:
        lean = unbias(lean, LEAN_BIAS)
    if not lean_filtering:
        # naive mip: rebuild second moments from the filtered means,
        # losing the variance the footprint accumulated (:306-310)
        lean = Lrep(E1=lean.E1, E2=lean.E2, E3=lean.E1 * lean.E1,
                    E4=lean.E2 * lean.E2, E5=lean.E1 * lean.E2)
    lean = lean * dmap_scale
    base = params_to_lrep(base_params)
    return lrep_to_params(lean + base)


@pytree_dataclass
class FilteredBeckmannMaterial:
    """A Beckmann conductor with LEAN-filtered normal maps: the whole
    dj_beckmannconductor material as one pytree. ``lean`` holds the
    per-texel (or per-pixel, after footprint lookup) moments."""

    lean: Lrep
    base_params: MicrofacetParams
    eta: jnp.ndarray            # conductor ior (3,)
    k: jnp.ndarray              # conductor extinction (3,)
    dmap_scale: jnp.ndarray = None
    lean_filtering: bool = static_field(default=True)
    biased: bool = static_field(default=False)
    #: fetch from a mip pyramid selected by the path tracer's per-ray
    #: footprint (ray-cone LOD) instead of always level 0 — the LEAN
    #: minification story (the reference gets this from Mitsuba's mip
    #: machinery + its leanFiltering toggle; here the pyramid is the
    #: moment average, exact for the mixture of texel NDFs)
    mip_lod: bool = static_field(default=False)

    def params(self) -> MicrofacetParams:
        scale = 1.0 if self.dmap_scale is None else self.dmap_scale
        return filtered_params(self.lean, self.base_params, scale,
                               self.lean_filtering, self.biased)

    def pvec_provider(self):
        """Per-hit provider for the path tracer's fused loop when
        ``lean`` holds full (H, W) moment maps: the 5 LEAN moments
        pack into one (H*W, 5) table (once per trace, outside the
        bounce scan), and ``assemble`` unbiases/combines/converts a
        fetched row exactly as :func:`filtered_params` — the
        per-shading-point LEAN fetch the reference runs inside any
        Mitsuba integrator (dj_beckmannconductor.cpp:280-428). Fresnel
        rides separately as the exact conductor form (pvec f0 rows are
        unused)."""
        import numpy as np

        from dj_brdf_tpu.render.materials import (TextureProvider,
                                                  texel_index)
        from dj_brdf_tpu.render.pathtrace import _stack_pvec

        h, w = self.lean.E1.shape
        scale = 1.0 if self.dmap_scale is None else self.dmap_scale

        def pack(lrep):
            return jnp.stack([lrep.E1, lrep.E2, lrep.E3, lrep.E4,
                              lrep.E5], -1).reshape(-1, 5)

        if self.mip_lod:
            # flatten the moment pyramid level-major; per-lane level
            # select costs three tiny (L,) gathers for (offset, h, w)
            from dj_brdf_tpu.lean.maps import build_mip_pyramid
            levels = build_mip_pyramid(self.lean)
            packs = [pack(l) for l in levels]
            packed = jnp.concatenate(packs, axis=0)
            sizes = [p.shape[0] for p in packs]
            off_t = jnp.asarray(np.cumsum([0] + sizes[:-1]), jnp.int32)
            h_t = jnp.asarray([l.E1.shape[0] for l in levels], jnp.int32)
            w_t = jnp.asarray([l.E1.shape[1] for l in levels], jnp.int32)
            n_levels = len(levels)

            def index(uu, vv, lod=None):
                if lod is None:
                    return texel_index(h, w, uu, vv)
                lvl = jnp.clip(jnp.round(lod).astype(jnp.int32), 0,
                               n_levels - 1)
                h_l = jnp.take(h_t, lvl)
                w_l = jnp.take(w_t, lvl)
                yi = jnp.clip((vv * h_l).astype(jnp.int32), 0, h_l - 1)
                xi = jnp.clip((uu * w_l).astype(jnp.int32), 0, w_l - 1)
                return jnp.take(off_t, lvl) + yi * w_l + xi
        else:
            packed = pack(self.lean)

            def index(uu, vv, lod=None):
                return texel_index(h, w, uu, vv)

        def assemble(row):
            lean_px = Lrep(E1=row[..., 0], E2=row[..., 1], E3=row[..., 2],
                           E4=row[..., 3], E5=row[..., 4])
            p = filtered_params(lean_px, self.base_params, scale,
                                self.lean_filtering, self.biased)
            return _stack_pvec(p.ax, p.ay, p.rho, p.txn, p.tyn,
                               0.0, 0.0, 0.0)

        # identity-ish moments: zero mean slopes, unit second moments
        neutral = jnp.asarray([0.0, 0.0, 1.0, 1.0, 0.0], jnp.float32)
        return TextureProvider(packed=packed, h=h, w=w,
                               assemble=assemble, neutral=neutral,
                               index=index, wants_lod=self.mip_lod)

    def evalp(self, i, o):
        """f_r*cos with exact conductor Fresnel on top (reference
        :317-327; fresnelConductorExact at dot(o, h))."""
        from dj_brdf_tpu.fresnel import conductor_fresnel
        params = self.params()
        dist = Beckmann()
        from dj_brdf_tpu import fresnel as fm
        base = mf.evalp(dist, fm.Ideal(), params, i, o)
        h = normalize(i + o, eps=1e-24)
        f = conductor_fresnel(jnp.clip(dot(o, h), 0.0, 1.0), self.eta, self.k)
        return base * f

    def sample(self, u1, u2, o):
        return mf.sample(Beckmann(), self.params(), u1, u2, o)

    def pdf(self, i, o):
        return mf.pdf(Beckmann(), self.params(), i, o)

    def evalp_is(self, u1, u2, o):
        """Sample + weight (reference evalp_is dj_brdf.h:1734-1765
        with the plugin's conductor Fresnel, dj_beckmannconductor.cpp:
        371-428) via the fused SoA Beckmann kernel — params may be
        per-pixel (the LEAN case), they broadcast per lane."""
        from dj_brdf_tpu.fresnel import conductor_fresnel
        from dj_brdf_tpu.ops.soa import beckmann_evalp_is_soa
        p = self.params()

        def cond_f(cosd):
            f = conductor_fresnel(cosd, self.eta, self.k)
            return f[..., 0], f[..., 1], f[..., 2]

        wr, wg, wb, ix, iy, iz, pdf = beckmann_evalp_is_soa(
            (p.ax, p.ay, p.rho, p.txn, p.tyn), u1, u2,
            o[..., 0], o[..., 1], o[..., 2], fresnel_fn=cond_f)
        return (jnp.stack([wr, wg, wb], -1),
                jnp.stack([ix, iy, iz], -1), pdf)
