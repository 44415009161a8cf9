"""A small differentiable path tracer.

The reference delegates light transport to Mitsuba's integrators and
only supplies BSDF plugins (mitsuba/*.cpp); the JAX equivalent
is this renderer: a sphere-on-ground-plane scene ("matpreview" style)
path-traced entirely inside one jitted program — fixed bounce count
via ``lax.scan``, per-pixel counter-based RNG, next-event estimation
for a directional (delta) light plus a constant sky, and any two
framework materials (sphere + floor) with their own importance
samplers. Differentiable end-to-end w.r.t. material parameters and
light direction; pixels/samples shard over the mesh data axis like
any other batch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dj_brdf_tpu.core.math import dot, normalize, vec3
from dj_brdf_tpu.render.sphere import _build_frame

_EPS = 1e-3


def world_to_local(n, v):
    t, b = _build_frame(n)
    return vec3(dot(v, t), dot(v, b), dot(v, n))


def local_to_world(n, v):
    t, b = _build_frame(n)
    return (v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n)


def _intersect(ro, rd):
    """Unit sphere at origin + ground plane z = -1.
    Returns (hit, t, n_world, is_sphere)."""
    # sphere |ro + t rd|^2 = 1
    b = dot(ro, rd)
    c = dot(ro, ro) - 1.0
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_s = jnp.where(disc > 0.0, -b - sq, jnp.inf)
    t_s = jnp.where(t_s > _EPS, t_s, jnp.inf)

    # plane z = -1
    dz = rd[..., 2]
    t_p = (-1.0 - ro[..., 2]) / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
    t_p = jnp.where((t_p > _EPS) & (jnp.abs(dz) > 1e-9), t_p, jnp.inf)

    is_sphere = t_s < t_p
    t = jnp.minimum(t_s, t_p)
    hit = jnp.isfinite(t)
    pos = ro + t[..., None] * rd
    n_sphere = normalize(pos, eps=1e-12)
    n_plane = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], ro.dtype),
                               ro.shape)
    n = jnp.where(is_sphere[..., None], n_sphere, n_plane)
    return hit, t, n, is_sphere


def _occluded(pos, dir_w):
    hit, _, _, _ = _intersect(pos, dir_w)
    return hit


def _material_eval(mats, is_sphere, fn_name, *args):
    """Static two-way material dispatch: evaluate both, select."""
    a = getattr(mats[0], fn_name)(*args)
    b = getattr(mats[1], fn_name)(*args)
    def sel(x, y):
        mask = is_sphere
        while mask.ndim < x.ndim:
            mask = mask[..., None]
        return jnp.where(mask, x, y)
    return jax.tree_util.tree_map(sel, a, b)


def _mats_at_hit(mats, is_sphere, pos):
    """Per-hit material specialization for the generic loop:
    materials exposing ``at_uv`` (UVMappedMaterial — textured alphas
    over tabular/any distributions) fetch their textures at the hit's
    uv and return an ordinary per-lane-parameter material; others pass
    through. This is the generic-loop half of the reference's
    per-shading-point texture evaluation (dj_brdf.cpp:353-357 with
    distribution=\"tabular\")."""
    if not any(hasattr(m, "at_uv") for m in mats):
        return mats
    uu, vv = _hit_uv(is_sphere, pos[..., 0], pos[..., 1], pos[..., 2])
    return tuple(m.at_uv(uu, vv) if hasattr(m, "at_uv") else m
                 for m in mats)


class _FusedInfo(NamedTuple):
    """Trace-time material description for the fused SoA render loops
    (static dispatch, like the reference's plugin-construction-time
    distribution resolution, mitsuba/dj_brdf.cpp:193-204)."""
    family: str            # "ggx" | "beck"
    caps: bool             # GGX spherical-caps sampler
    pvec: object           # (8,) uniform params, or None when textured
    pvec_at: object        # (uu, vv) -> (8, N) per-hit params, or None
    conductor: object      # (eta, k) exact conductor Fresnel, or None


def _fused_info(mat):
    """_FusedInfo when ``mat`` qualifies for the fused SoA kernels,
    else None. Covers: uniform GGX/Beckmann+Schlick MicrofacetMaterial,
    textured-alpha TexturedMicrofacetMaterial (per-hit roughness fetch,
    the dj_brdf plugin's integrator-orthogonal texture path,
    mitsuba/dj_brdf.cpp:353-357), and FilteredBeckmannMaterial with
    uniform or full-map LEAN moments (dj_beckmannconductor.cpp:280-428
    fetches LEAN maps per shading point inside any integrator)."""
    from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_tpu.microfacet.ndf import Beckmann, GGXSphericalCaps
    from dj_brdf_tpu.render.materials import (MicrofacetMaterial,
                                              TexturedMicrofacetMaterial)

    if isinstance(mat, TexturedMicrofacetMaterial):
        fam_caps = mat._fused_family()
        if fam_caps is None:
            return None
        fam, caps = fam_caps
        return _FusedInfo(fam, caps, None, mat.pvec_provider(), None)
    if isinstance(mat, MicrofacetMaterial):
        pv = mat._fused_pvec()
        if pv is None:
            return None
        fam = "beck" if type(mat.dist) is Beckmann else "ggx"
        return _FusedInfo(fam, isinstance(mat.dist, GGXSphericalCaps),
                          pv, None, None)
    if isinstance(mat, FilteredBeckmannMaterial):
        leaves = (mat.lean.E1, mat.lean.E2, mat.lean.E3, mat.lean.E4,
                  mat.lean.E5)
        cond = (mat.eta, mat.k)
        if all(getattr(x, "ndim", 0) == 0 for x in leaves):
            p = mat.params()
            pv = _stack_pvec(p.ax, p.ay, p.rho, p.txn, p.tyn,
                             0.0, 0.0, 0.0)
            return _FusedInfo("beck", False, pv, None, cond)
        if (all(getattr(x, "ndim", 0) == 2 for x in leaves)
                and len({x.shape for x in leaves}) == 1):
            return _FusedInfo("beck", False, None, mat.pvec_provider(),
                              cond)
        # mixed scalar/map moments (or mismatched map shapes) have no
        # sensible per-hit fetch — fail loudly instead of falling into
        # the generic loop's broadcasting error
        raise ValueError(
            "FilteredBeckmannMaterial LEAN moments must be all scalar "
            "or all (H, W) maps of one shape for the path tracer; got "
            f"shapes {[getattr(x, 'shape', ()) for x in leaves]}")
    return None


def _stack_pvec(ax, ay, rho, txn, tyn, f0r, f0g, f0b):
    """Broadcast-stack parameter components into the kernels' (8,) or
    (8, N) pvec layout."""
    parts = [jnp.asarray(x, jnp.float32)
             for x in (ax, ay, rho, txn, tyn, f0r, f0g, f0b)]
    shape = jnp.broadcast_shapes(*[p.shape for p in parts])
    return jnp.stack([jnp.broadcast_to(p, shape) for p in parts])


# uv period of the ground plane: one texture tile spans 4x4 world
# units (the sphere has radius 1), the role of the scene's uv
# parameterization in the reference's Mitsuba scenes
PLANE_UV_SCALE = 0.25


def _hit_uv(is_sphere, px, py, pz):
    """Per-hit texture coordinates: spherical uv on the sphere (same
    convention as render.sphere.sphere_uv) and tiled world-xy on the
    ground plane."""
    phi = jnp.arctan2(py, px)
    u_sph = jnp.mod(phi / (2.0 * jnp.pi), 1.0)
    v_sph = jnp.arccos(jnp.clip(pz, -1.0, 1.0)) / jnp.pi
    u_pln = jnp.mod(px * PLANE_UV_SCALE, 1.0)
    v_pln = jnp.mod(py * PLANE_UV_SCALE, 1.0)
    return (jnp.where(is_sphere, u_sph, u_pln),
            jnp.where(is_sphere, v_sph, v_pln))


def _select_pvec(is_sphere, pv0, pv1):
    if pv0.ndim == 1:
        pv0 = pv0[:, None]
    if pv1.ndim == 1:
        pv1 = pv1[:, None]
    return jnp.where(is_sphere[None, :], pv0, pv1)


def _make_fres_fn(infos, is_sphere, pv):
    """Per-lane Fresnel closure for the fused kernels when any
    material carries exact conductor Fresnel (the dj_beckmannconductor
    / --conductor path); None = Schlick from the pvec rows."""
    if all(info.conductor is None for info in infos):
        return None
    from dj_brdf_tpu.fresnel import conductor_fresnel

    def fres_fn(cosd):
        if any(info.conductor is None for info in infos):
            c1 = 1.0 - cosd
            c5 = (c1 * c1) * (c1 * c1) * c1
            Fr = pv[5] + c5 * (1.0 - pv[5])
            Fg = pv[6] + c5 * (1.0 - pv[6])
            Fb = pv[7] + c5 * (1.0 - pv[7])
        else:
            Fr = Fg = Fb = jnp.zeros_like(cosd)
        for mask, info in ((is_sphere, infos[0]), (~is_sphere, infos[1])):
            if info.conductor is not None:
                eta, k = info.conductor
                f = conductor_fresnel(cosd, eta, k)
                Fr = jnp.where(mask, f[..., 0], Fr)
                Fg = jnp.where(mask, f[..., 1], Fg)
                Fb = jnp.where(mask, f[..., 2], Fb)
        return Fr, Fg, Fb

    return fres_fn


def _check_no_textured_fallback(mats):
    """Textured materials fetch per-hit parameters inside the fused
    SoA loop only; the generic layered loop has no uv plumbing. Raise
    a useful error instead of an AttributeError deep in the scan."""
    from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_tpu.render.materials import TexturedMicrofacetMaterial
    for mat in mats:
        textured = isinstance(mat, TexturedMicrofacetMaterial) or (
            isinstance(mat, FilteredBeckmannMaterial)
            and any(getattr(x, "ndim", 0) == 2 for x in
                    (mat.lean.E1, mat.lean.E2, mat.lean.E3,
                     mat.lean.E4, mat.lean.E5)))
        if textured:
            raise ValueError(
                f"{type(mat).__name__} with texture maps needs the fused "
                "SoA path: pair it with a fused-capable material "
                "(GGX/Beckmann + Schlick MicrofacetMaterial, "
                "TexturedMicrofacetMaterial, or FilteredBeckmannMaterial)"
                " — the generic loop cannot fetch per-hit textures")


def _texture_ctx(infos):
    """When BOTH materials carry packed textures, pad their tables to
    a common width and concatenate them once (outside the bounce scan)
    — sphere and floor lanes are disjoint, so one gather per bounce
    serves both materials' fetches. Returns (combined, row_offset,
    widths) or None."""
    provs = [getattr(info, "pvec_at", None) for info in infos]
    if any(p is None or p.packed is None for p in provs):
        return None
    k0 = provs[0].packed.shape[1]
    k1 = provs[1].packed.shape[1]
    k = max(k0, k1)

    def pad(p):
        t = p.packed
        if t.shape[1] < k:
            t = jnp.pad(t, ((0, 0), (0, k - t.shape[1])))
        return t

    combined = jnp.concatenate([pad(provs[0]), pad(provs[1])], axis=0)
    return combined, provs[0].packed.shape[0], (k0, k1)


def _needs_lod(infos):
    """True when some provider fetches from a mip pyramid (ray-cone
    LOD); the render loops only track footprints then."""
    return any(info is not None and info.pvec_at is not None
               and info.pvec_at.wants_lod for info in infos)


def _lod_for(provider, is_sphere, cone_w):
    """Per-lane mip level from the ray cone's world-space width: the
    uv footprint is width x du/dworld of the hit geometry (sphere
    equator: 1/2pi; plane: the uv tiling scale), and the level is
    log2 of that footprint in base-level texels — the standard
    ray-cones texture LOD (isotropic-footprint approximation;
    incidence elongation ignored)."""
    if cone_w is None or not provider.wants_lod:
        return None
    fp_uv = cone_w * jnp.where(is_sphere, 1.0 / (2.0 * jnp.pi),
                               PLANE_UV_SCALE)
    return jnp.log2(jnp.maximum(fp_uv * provider.w, 1e-9))


def _resolve_scene(infos, tex_ctx, is_sphere, px, py, pz, cone_w=None):
    """Per-lane (8, N) pvec + Fresnel closure for a bounce's hit
    points: textured materials fetch their maps at the per-hit uv
    (mip level from the ray-cone footprint when the provider wants
    LOD), uniform materials broadcast — the bounce-loop half of the
    reference's per-shading-point texture evaluation
    (dj_brdf.cpp:353-357). With two textured materials the fetch is
    ONE combined gather (``tex_ctx``); otherwise one per textured
    material."""
    textured = [info.pvec is None for info in infos]
    if any(textured):
        uu, vv = _hit_uv(is_sphere, px, py, pz)
    if tex_ctx is not None:
        combined, off, (k0, k1) = tex_ctx
        p0, p1 = infos[0].pvec_at, infos[1].pvec_at
        idx0 = p0.index(uu, vv, _lod_for(p0, is_sphere, cone_w))
        idx1 = p1.index(uu, vv, _lod_for(p1, is_sphere, cone_w)) + off
        row = jnp.take(combined, jnp.where(is_sphere, idx0, idx1),
                       axis=0)
        # off-lane bytes belong to the OTHER material; substitute each
        # provider's neutral row there so its assembly math never sees
        # garbage (keeps reverse-mode free of 0 * inf NaNs)
        m = is_sphere[..., None]
        pvs = [p0.assemble(jnp.where(m, row[..., :k0], p0.neutral)),
               p1.assemble(jnp.where(m, p1.neutral, row[..., :k1]))]
    else:
        def resolve(info):
            if info.pvec is not None:
                return info.pvec
            p = info.pvec_at
            if p.packed is None:
                return p.assemble(None)
            idx = p.index(uu, vv, _lod_for(p, is_sphere, cone_w))
            return p.assemble(jnp.take(p.packed, idx, axis=0))

        pvs = [resolve(info) for info in infos]
    pv = _select_pvec(is_sphere, *pvs)
    return pv, _make_fres_fn(infos, is_sphere, pv)


def _fused_nee_and_sample(infos, pv, fres_fn, is_sphere, l_comp, u1, u2,
                          o_comp):
    """NEE evalp + BSDF sample through the fused SoA kernels
    (ops/soa.py) instead of the layered both-materials path, which
    evaluates both materials on every lane. Same-family material
    pairs issue ONE kernel per op on the per-lane-selected (8, N)
    ``pv``; mixed pairs issue one dual-family kernel (the sampler and
    the NEE eval share the receiver warp via XLA CSE inside the jit).

    ``l_comp``/``o_comp``: (lx, ly, lz) / (ox, oy, oz) component
    arrays; ``pv``/``fres_fn`` from :func:`_resolve_scene`. Returns
    the 10-tuple (fr, fg, fb, wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_tpu.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            f3 = soa.beckmann_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                        fresnel_fn=fres_fn)
            out = soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz,
                                            fresnel_fn=fres_fn)
        else:
            f3 = soa.ggx_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                   fresnel_fn=fres_fn)
            out = soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps,
                                       fresnel_fn=fres_fn)
        return f3 + out  # 10-tuple of component arrays

    if fam0 == fam1 and caps0 == caps1:
        return run(fam0, caps0)
    if {fam0, fam1} == {"ggx", "beck"}:
        # GGX/Beckmann mix: ONE dual-family kernel — shared chain,
        # per-lane select of the distribution-specific scalars; the
        # GGX lanes keep their material's sampler (caps or qf)
        is_beck = is_sphere if fam0 == "beck" else ~is_sphere
        # caps flag of the GGX-side material (Beckmann has no caps
        # sampler; or-ing would silently misroute a future flagged dist)
        ggx_caps = caps0 if fam0 == "ggx" else caps1
        return soa.mixed_nee_evalp_is_soa(pv, is_beck, lx, ly, lz,
                                          u1, u2, ox, oy, oz,
                                          caps=ggx_caps,
                                          fresnel_fn=fres_fn)
    res0 = run(fam0, caps0)
    res1 = run(fam1, caps1)
    return tuple(jnp.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_nee_pdf_and_sample(infos, pv, fres_fn, is_sphere, l_comp,
                              u1, u2, o_comp):
    """Like :func:`_fused_nee_and_sample` but additionally returns the
    BSDF sampler's pdf at the NEE direction (the MIS counter-pdf for
    environment lighting). 11-tuple: (fr, fg, fb, pdf_nee, wr, wg, wb,
    ix, iy, iz, pdf)."""
    from dj_brdf_tpu.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam, caps):
        if fam == "beck":
            f4 = soa.beckmann_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                        with_pdf=True, fresnel_fn=fres_fn)
            out = soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz,
                                            fresnel_fn=fres_fn)
        else:
            f4 = soa.ggx_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                   with_pdf=True, fresnel_fn=fres_fn)
            out = soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps,
                                       fresnel_fn=fres_fn)
        return f4 + out  # 11-tuple

    if fam0 == fam1 and caps0 == caps1:
        return run(fam0, caps0)
    if {fam0, fam1} == {"ggx", "beck"}:
        is_beck = is_sphere if fam0 == "beck" else ~is_sphere
        ggx_caps = caps0 if fam0 == "ggx" else caps1
        return soa.mixed_nee_evalp_is_soa(pv, is_beck, lx, ly, lz,
                                          u1, u2, ox, oy, oz,
                                          caps=ggx_caps,
                                          with_nee_pdf=True,
                                          fresnel_fn=fres_fn)
    res0 = run(fam0, caps0)
    res1 = run(fam1, caps1)
    return tuple(jnp.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_nee_eval(infos, pv, fres_fn, is_sphere, l_comp, o_comp):
    """NEE evalp only (fr, fg, fb) — the spp-deduplicated first bounce
    evaluates the light term once per pixel."""
    from dj_brdf_tpu.ops import soa

    fam0, fam1 = infos[0].family, infos[1].family
    lx, ly, lz = l_comp
    ox, oy, oz = o_comp

    def run(fam):
        if fam == "beck":
            return soa.beckmann_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                          fresnel_fn=fres_fn)
        return soa.ggx_evalp_soa(pv, lx, ly, lz, ox, oy, oz,
                                 fresnel_fn=fres_fn)

    if fam0 == fam1:
        return run(fam0)
    res0 = run(fam0)
    res1 = run(fam1)
    return tuple(jnp.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _fused_sample(infos, pv, fres_fn, is_sphere, u1, u2, o_comp):
    """BSDF sample + IS weight only (wr, wg, wb, ix, iy, iz, pdf)."""
    from dj_brdf_tpu.ops import soa

    fam0, caps0 = infos[0].family, infos[0].caps
    fam1, caps1 = infos[1].family, infos[1].caps
    ox, oy, oz = o_comp
    zero = jnp.zeros_like(ox)

    def run(fam, caps):
        if fam == "beck":
            return soa.beckmann_evalp_is_soa(pv, u1, u2, ox, oy, oz,
                                             fresnel_fn=fres_fn)
        return soa.ggx_evalp_is_soa(pv, u1, u2, ox, oy, oz, caps=caps,
                                    fresnel_fn=fres_fn)

    if fam0 == fam1 and caps0 == caps1:
        return run(fam0, caps0)
    if {fam0, fam1} == {"ggx", "beck"}:
        is_beck = is_sphere if fam0 == "beck" else ~is_sphere
        return soa.mixed_nee_evalp_is_soa(pv, is_beck, zero, zero, zero,
                                          u1, u2, ox, oy, oz,
                                          caps=caps0 or caps1,
                                          with_nee=False,
                                          fresnel_fn=fres_fn)
    res0 = run(fam0, caps0)
    res1 = run(fam1, caps1)
    return tuple(jnp.where(is_sphere, a, b) for a, b in zip(res0, res1))


def _intersect_soa(rox, roy, roz, rdx, rdy, rdz):
    """Component-array intersection (same scene/semantics as
    :func:`_intersect`): returns (hit, t, nx, ny, nz, is_sphere,
    px, py, pz). The whole fast path works on flat (N,) component
    arrays end to end, so elementwise work never strides over a
    3-wide minor axis."""
    b = rox * rdx + roy * rdy + roz * rdz
    c = rox * rox + roy * roy + roz * roz - 1.0
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_s = jnp.where(disc > 0.0, -b - sq, jnp.inf)
    t_s = jnp.where(t_s > _EPS, t_s, jnp.inf)

    t_p = (-1.0 - roz) / jnp.where(jnp.abs(rdz) < 1e-9, 1e-9, rdz)
    t_p = jnp.where((t_p > _EPS) & (jnp.abs(rdz) > 1e-9), t_p, jnp.inf)

    is_sphere = t_s < t_p
    t = jnp.minimum(t_s, t_p)
    hit = jnp.isfinite(t)
    ts = jnp.where(hit, t, 0.0)  # keep miss-lane positions finite
    px, py, pz = rox + ts * rdx, roy + ts * rdy, roz + ts * rdz
    inrm = jax.lax.rsqrt(jnp.maximum(px * px + py * py + pz * pz, 1e-24))
    nx = jnp.where(is_sphere, px * inrm, 0.0)
    ny = jnp.where(is_sphere, py * inrm, 0.0)
    nz = jnp.where(is_sphere, pz * inrm, 1.0)
    return hit, t, nx, ny, nz, is_sphere, px, py, pz


def _build_frame_soa(nx, ny, nz):
    """Branchless tangent frame (Duff et al.), component form of
    render.sphere._build_frame."""
    s = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    tx, ty, tz = 1.0 + s * nx * nx * a, s * b, -s * nx
    bx, by, bz = b, s + ny * ny * a, -ny
    return tx, ty, tz, bx, by, bz


@partial(jax.jit, static_argnames=("res", "spp", "max_bounces", "mesh",
                                   "jitter"))
def render(sphere_mat, floor_mat, light_dir, light_radiance, sky_radiance,
           res: int = 256, spp: int = 8, max_bounces: int = 3,
           key=None, mesh=None, jitter: bool = False, envmap=None):
    """Path-trace the scene. Returns an (res, res, 3) HDR image.

    ``envmap``: optional :class:`dj_brdf_tpu.render.envmap.EnvMap`.
    When given it REPLACES the delta light and constant sky (the
    Mitsuba-envelope lighting of the reference's matpreview scene,
    mitsuba/README): every bounce combines envmap importance sampling
    with BSDF sampling by the power heuristic (MIS), and misses read
    the envmap radiance with the matching weight. Differentiable
    w.r.t. the envmap radiance (inverse lighting) as well as material
    parameters.

    ``sphere_mat``/``floor_mat``: any material with evalp/evalp_is in
    the local frame (see render.materials). ``light_dir`` points
    *toward* the light (a delta directional light). With ``mesh``, the
    ray batch is sharding-constrained over the mesh's data axis so XLA
    partitions the whole per-ray pipeline across devices (materials
    replicate; the device count should divide res*res*spp).

    ``jitter=True`` perturbs each sample's sensor position uniformly
    within its pixel footprint (the per-sample bRec context of the
    reference's Mitsuba integrators, mitsuba/dj_brdf.cpp:342-439), so
    spp buys edge anti-aliasing as well as BSDF-variance reduction.
    Default False = all spp copies of a pixel share the camera ray —
    which is exactly what makes the spp-deduplicated first bounce an
    identity optimization, so dedup is gated on ``not jitter``. The
    jitter stream is a fold of ``key``; ``jitter=False`` output is
    bit-identical to earlier versions.

    The default ``key`` is a threefry key, whose bits are
    partition-invariant: a mesh-sharded render draws the same samples
    as the unsharded one and agrees to f32 rounding (per-pixel sums
    may run in another order; tested). Other generators (``jax.random.key(0,
    impl="rbg")``) are accepted; their bits may change with the
    sharding — same image statistics, different noise."""
    if key is None:
        key = jax.random.PRNGKey(0)
    light_dir = normalize(jnp.asarray(light_dir, jnp.float32))
    light_rad = jnp.asarray(light_radiance, jnp.float32)
    sky_rad = jnp.asarray(sky_radiance, jnp.float32)
    mats = (sphere_mat, floor_mat)

    # pinhole camera looking -y at the sphere
    cam_pos = jnp.asarray([0.0, 3.2, 0.6], jnp.float32)
    look = normalize(-cam_pos + jnp.asarray([0.0, 0.0, 0.0]))
    right = normalize(jnp.cross(look, jnp.asarray([0.0, 0.0, 1.0])))
    up = jnp.cross(right, look)

    xs = (jnp.arange(res, dtype=jnp.float32) + 0.5) / res * 2.0 - 1.0
    px, py = jnp.meshgrid(xs, -xs)
    n_rays = res * res * spp
    px = jnp.tile(px.reshape(-1), spp)
    py = jnp.tile(py.reshape(-1), spp)
    if jitter:
        ju = jax.random.uniform(jax.random.fold_in(key, 0x5e75),
                                (n_rays, 2), minval=-1.0 / res,
                                maxval=1.0 / res)
        px = px + ju[:, 0]
        py = py + ju[:, 1]
    fov_scale = 0.62
    rd = normalize(look + fov_scale * (px[..., None] * right
                                       + py[..., None] * up))
    ro = jnp.broadcast_to(cam_pos, rd.shape)

    u = jax.random.uniform(key, (max_bounces, n_rays, 2))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from dj_brdf_tpu.parallel.mesh import DATA_AXIS
        ray_s = NamedSharding(mesh, P(DATA_AXIS))
        ro = jax.lax.with_sharding_constraint(ro, ray_s)
        rd = jax.lax.with_sharding_constraint(rd, ray_s)
        u = jax.lax.with_sharding_constraint(
            u, NamedSharding(mesh, P(None, DATA_AXIS)))

    if envmap is not None:
        # dedicated envmap stream: the BSDF stream stays bit-identical
        # to the delta-light renders. 3 uniforms per NEE draw: bin row
        # + accept, bin column + phi offset, theta offset (see
        # EnvMap.sample_grid's f32 bit budget)
        u_env = jax.random.uniform(jax.random.fold_in(key, 0xE57),
                                   (max_bounces, n_rays, 3))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from dj_brdf_tpu.parallel.mesh import DATA_AXIS
            u_env = jax.lax.with_sharding_constraint(
                u_env, NamedSharding(mesh, P(None, DATA_AXIS)))
        infos = (_fused_info(sphere_mat), _fused_info(floor_mat))
        if all(x is not None for x in infos):
            return _render_envmap_soa(infos, envmap, ro, rd, u, u_env,
                                      res, spp,
                                      cone_spread0=2.0 * fov_scale / res)
        _check_no_textured_fallback(mats)
        return _render_envmap(mats, envmap, ro, rd, u, u_env, res, spp)

    # static material dispatch: both materials fused-capable -> the
    # flat component-array (SoA) loop; otherwise the generic
    # both-evaluate path on (..., 3) arrays
    infos = (_fused_info(sphere_mat), _fused_info(floor_mat))
    if all(x is not None for x in infos):
        return _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                           res, spp, dedup_ok=not jitter,
                           cone_spread0=2.0 * fov_scale / res)
    _check_no_textured_fallback(mats)

    def bounce(carry, u_b):
        ro, rd, throughput, radiance, alive = carry
        hit, t, n, is_sphere = _intersect(ro, rd)

        # miss -> sky
        radiance = radiance + jnp.where(
            (alive & ~hit)[..., None], throughput * sky_rad, 0.0)
        alive = alive & hit

        pos = ro + t[..., None] * rd
        o_loc = world_to_local(n, -rd)
        mats_b = _mats_at_hit(mats, is_sphere,
                              jnp.where(hit[..., None], pos, ro))

        # next-event estimation toward the delta light
        i_loc = world_to_local(n, jnp.broadcast_to(light_dir, rd.shape))
        shadow_o = pos + n * _EPS * 3.0
        lit = ~_occluded(shadow_o, jnp.broadcast_to(light_dir, rd.shape))

        f = _material_eval(mats_b, is_sphere, "evalp", i_loc, o_loc)
        w, i_s, pdf = _material_eval(mats_b, is_sphere, "evalp_is",
                                     u_b[:, 0], u_b[:, 1], o_loc)

        contrib = throughput * light_rad * f
        ok = alive & lit & (i_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
        radiance = radiance + jnp.where(ok[..., None], contrib, 0.0)

        throughput = throughput * jnp.where(alive[..., None], w, 1.0)
        alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
        # detached sampling — see _render_soa
        i_s = jax.lax.stop_gradient(i_s)
        rd_new = normalize(local_to_world(n, i_s), eps=1e-12)
        ro_new = pos + n * _EPS * 3.0
        ro = jnp.where(alive[..., None], ro_new, ro)
        rd = jnp.where(alive[..., None], rd_new, rd)
        return (ro, rd, throughput, radiance, alive), None

    init = (ro, rd, jnp.ones_like(rd), jnp.zeros_like(rd),
            jnp.ones(n_rays, bool))
    (ro, rd, throughput, radiance, alive), _ = jax.lax.scan(bounce, init, u)
    # terminate remaining paths into the sky
    hit, _, _, _ = _intersect(ro, rd)
    radiance = radiance + jnp.where((alive & ~hit)[..., None],
                                    throughput * sky_rad, 0.0)

    img = radiance.reshape(spp, res, res, 3).mean(axis=0)
    return img


def _render_envmap(mats, em, ro, rd, u, u_env, res: int, spp: int):
    """Environment-lit transport with multiple importance sampling.

    Per bounce: one envmap NEE sample (divided by its true pdf,
    weighted by the power heuristic against the BSDF's pdf at that
    direction) plus one BSDF sample whose radiance is collected at the
    NEXT segment's miss, weighted against the envmap's pdf there. The
    camera ray's direct envmap hit carries weight 1 (no competing
    strategy). Runs the generic layered material dispatch — any
    framework material with evalp/pdf/evalp_is works."""
    from dj_brdf_tpu.render.envmap import power_heuristic

    n_rays = rd.shape[0]

    def env_lookup(d):
        """radiance + sampling pdf toward d: one packed row gather."""
        r, g, b, pdf = em.eval_with_pdf(d[..., 0], d[..., 1], d[..., 2])
        return jnp.stack([r, g, b], -1), pdf

    def bounce(carry, u_b):
        ro, rd, throughput, radiance, alive, prev_pdf = carry
        u_bsdf, u_nee = u_b
        hit, t, n, is_sphere = _intersect(ro, rd)

        # miss -> envmap radiance, MIS-weighted against the pdf of the
        # BSDF sample that produced this segment (prev_pdf < 0 marks
        # the deterministic camera ray: weight 1)
        le_miss, pdf_env_rd = env_lookup(rd)
        w_mis = jnp.where(prev_pdf < 0.0, 1.0,
                          power_heuristic(prev_pdf, pdf_env_rd))
        miss = alive & ~hit
        radiance = radiance + jnp.where(
            miss[..., None], throughput * le_miss
            * w_mis[..., None], 0.0)
        alive = alive & hit

        pos = ro + t[..., None] * rd
        o_loc = world_to_local(n, -rd)
        mats_b = _mats_at_hit(mats, is_sphere,
                              jnp.where(hit[..., None], pos, ro))

        # next-event estimation: one envmap importance sample
        ldx, ldy, ldz, pdf_l = em.sample(u_nee[:, 0], u_nee[:, 1],
                                         u_nee[:, 2])
        l_world = jnp.stack([ldx, ldy, ldz], -1)
        l_loc = world_to_local(n, l_world)
        shadow_o = pos + n * _EPS * 3.0
        lit = ~_occluded(shadow_o, l_world)

        f = _material_eval(mats_b, is_sphere, "evalp", l_loc, o_loc)
        pdf_b_at_l = _material_eval(mats_b, is_sphere, "pdf", l_loc,
                                    o_loc)
        le, _ = env_lookup(l_world)
        w_nee = power_heuristic(pdf_l, jnp.maximum(pdf_b_at_l, 0.0))
        contrib = (throughput * le * f
                   * (w_nee / jnp.maximum(pdf_l, 1e-12))[..., None])
        ok = alive & lit & (l_loc[..., 2] > 0.0) & (o_loc[..., 2] > 0.0)
        radiance = radiance + jnp.where(ok[..., None], contrib, 0.0)

        # BSDF sampling continues the path; its pdf feeds the next
        # segment's MIS weight
        w, i_s, pdf = _material_eval(mats_b, is_sphere, "evalp_is",
                                     u_bsdf[:, 0], u_bsdf[:, 1], o_loc)
        throughput = throughput * jnp.where(alive[..., None], w, 1.0)
        alive = alive & (pdf > 0.0) & (i_s[..., 2] > 0.0)
        # detached sampling — see _render_soa
        i_s = jax.lax.stop_gradient(i_s)
        rd_new = normalize(local_to_world(n, i_s), eps=1e-12)
        ro = jnp.where(alive[..., None], shadow_o, ro)
        rd = jnp.where(alive[..., None], rd_new, rd)
        prev_pdf = jnp.where(alive, pdf, prev_pdf)
        return (ro, rd, throughput, radiance, alive, prev_pdf), None

    init = (ro, rd, jnp.ones_like(rd), jnp.zeros_like(rd),
            jnp.ones(n_rays, bool), jnp.full((n_rays,), -1.0, jnp.float32))
    (ro, rd, throughput, radiance, alive, prev_pdf), _ = jax.lax.scan(
        bounce, init, (u, u_env))
    # terminate remaining live paths into the envmap (MIS-weighted)
    hit, _, _, _ = _intersect(ro, rd)
    miss = alive & ~hit
    le_fin, pdf_env_fin = env_lookup(rd)
    w_mis = jnp.where(prev_pdf < 0.0, 1.0,
                      power_heuristic(prev_pdf, pdf_env_fin))
    radiance = radiance + jnp.where(
        miss[..., None], throughput * le_fin * w_mis[..., None], 0.0)
    return radiance.reshape(spp, res, res, 3).mean(axis=0)


def _render_envmap_soa(infos, em, ro, rd, u, u_env, res: int, spp: int,
                       cone_spread0: float = 0.0):
    """Environment-lit MIS transport on flat component arrays with the
    fused material kernels — the SoA counterpart of
    :func:`_render_envmap`. Per bounce exactly TWO emitter gathers:
    one 4-wide alias row for the importance draw (direction + exact
    pdf), and one combined 16-wide packed row serving the miss lanes'
    radiance+pdf (at the segment direction) and the surviving lanes'
    NEE radiance (at the drawn direction) — miss and NEE lanes are
    disjoint, so they share the gather. Plus ONE fused material kernel
    producing the NEE eval, its MIS counter-pdf, and the BSDF sample
    together (mixed GGX/Beckmann scenes keep the dual-family
    single-kernel dispatch)."""
    from dj_brdf_tpu.render.envmap import power_heuristic

    n_rays = rd.shape[0]
    h_em, w_em = em.radiance.shape[:2]
    u = jnp.moveaxis(u, -1, 1)
    u_env = jnp.moveaxis(u_env, -1, 1)
    off = _EPS * 3.0
    tex_ctx = _texture_ctx(infos)
    track_lod = _needs_lod(infos)

    def bounce(carry, u_b):
        if track_lod:
            (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
             ra_r, ra_g, ra_b, alive, prev_pdf, cw, cs) = carry
        else:
            (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
             ra_r, ra_g, ra_b, alive, prev_pdf) = carry
            cw = cs = None
        u_bsdf, u_nee = u_b
        hit, t, nx, ny, nz, is_sphere, px, py, pz = _intersect_soa(
            rox, roy, roz, rdx, rdy, rdz)
        if track_lod:
            cw = cw + cs * jnp.where(hit, t, 0.0)
        miss = alive & ~hit

        # emitter importance draw: grid position + exact bin density
        # from ONE alias-row gather
        tg, pg, pb_l = em.sample_grid(u_nee[0], u_nee[1], u_nee[2])
        theta_l = tg * (jnp.pi / h_em)
        phi_l = pg * (2.0 * jnp.pi / w_em)
        sin_l = jnp.sin(theta_l)
        llx = sin_l * jnp.cos(phi_l)
        lly = sin_l * jnp.sin(phi_l)
        llz = jnp.cos(theta_l)
        ldx, ldy, ldz = em._to_world(llx, lly, llz)
        pdf_l = pb_l / jnp.maximum(sin_l, 1e-6)

        # combined packed gather: miss lanes read the segment
        # direction's cell, surviving lanes the NEE cell (disjoint)
        mlx, mly, mlz = em._to_local(rdx, rdy, rdz)
        idx_m, f1m, f2m, sin_m = em._cell(mlx, mly, mlz)
        idx_n, f1n, f2n = em._cell_from_grid(tg, pg)
        idx = jnp.where(miss, idx_m, idx_n)
        f1 = jnp.where(miss, f1m, f1n)
        f2 = jnp.where(miss, f2m, f2n)
        cr, cg, cb, pb_sel = em._lookup(idx, f1, f2)

        # miss -> envmap radiance with MIS against the generating
        # BSDF pdf (prev_pdf < 0 marks the camera ray)
        pdf_env_rd = pb_sel / sin_m
        w_mis = jnp.where(prev_pdf < 0.0, 1.0,
                          power_heuristic(prev_pdf, pdf_env_rd))
        ra_r = ra_r + jnp.where(miss, th_r * cr * w_mis, 0.0)
        ra_g = ra_g + jnp.where(miss, th_g * cg * w_mis, 0.0)
        ra_b = ra_b + jnp.where(miss, th_b * cb * w_mis, 0.0)
        alive = alive & hit

        tx, ty, tz, bx, by, bz = _build_frame_soa(nx, ny, nz)
        ox = -(rdx * tx + rdy * ty + rdz * tz)
        oy = -(rdx * bx + rdy * by + rdz * bz)
        oz = -(rdx * nx + rdy * ny + rdz * nz)

        # NEE radiance: the same combined gather's values on the
        # surviving (non-miss) lanes
        le_r, le_g, le_b = cr, cg, cb
        lx = ldx * tx + ldy * ty + ldz * tz
        ly = ldx * bx + ldy * by + ldz * bz
        lz = ldx * nx + ldy * ny + ldz * nz

        sox, soy, soz = px + nx * off, py + ny * off, pz + nz * off
        s_hit = _intersect_soa(sox, soy, soz,
                               jnp.broadcast_to(ldx, sox.shape),
                               jnp.broadcast_to(ldy, sox.shape),
                               jnp.broadcast_to(ldz, sox.shape))[0]
        lit = ~s_hit

        pv, fres_fn = _resolve_scene(infos, tex_ctx, is_sphere, px, py,
                                     pz, cone_w=cw)
        (fr, fg, fb, pdf_nee, wr, wg, wb, ixl, iyl, izl,
         pdf) = _fused_nee_pdf_and_sample(
            infos, pv, fres_fn, is_sphere, (lx, ly, lz), u_bsdf[0],
            u_bsdf[1], (ox, oy, oz))

        w_nee = power_heuristic(pdf_l, pdf_nee) / jnp.maximum(pdf_l, 1e-12)
        ok = alive & lit & (lz > 0.0) & (oz > 0.0)
        scale = jnp.where(ok, w_nee, 0.0)
        ra_r = ra_r + th_r * le_r * fr * scale
        ra_g = ra_g + th_g * le_g * fg * scale
        ra_b = ra_b + th_b * le_b * fb * scale

        th_r = th_r * jnp.where(alive, wr, 1.0)
        th_g = th_g * jnp.where(alive, wg, 1.0)
        th_b = th_b * jnp.where(alive, wb, 1.0)
        alive = alive & (pdf > 0.0) & (izl > 0.0)

        # detached sampling — see _render_soa
        ixl, iyl, izl = (jax.lax.stop_gradient(ixl),
                         jax.lax.stop_gradient(iyl),
                         jax.lax.stop_gradient(izl))

        wx = ixl * tx + iyl * bx + izl * nx
        wy = ixl * ty + iyl * by + izl * ny
        wz = ixl * tz + iyl * bz + izl * nz
        inrm = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz,
                                         1e-12))
        rdx = jnp.where(alive, wx * inrm, rdx)
        rdy = jnp.where(alive, wy * inrm, rdy)
        rdz = jnp.where(alive, wz * inrm, rdz)
        rox = jnp.where(alive, sox, rox)
        roy = jnp.where(alive, soy, roy)
        roz = jnp.where(alive, soz, roz)
        prev_pdf = jnp.where(alive, pdf, prev_pdf)
        if track_lod:
            cs = cs + jnp.where(alive, jnp.minimum(pv[0], 1.0), 0.0)
            return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
                    ra_r, ra_g, ra_b, alive, prev_pdf, cw, cs), None
        return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
                ra_r, ra_g, ra_b, alive, prev_pdf), None

    ones = jnp.ones(n_rays, jnp.float32)
    zeros = jnp.zeros(n_rays, jnp.float32)
    init = (ro[..., 0], ro[..., 1], ro[..., 2],
            rd[..., 0], rd[..., 1], rd[..., 2],
            ones, ones, ones, zeros, zeros, zeros,
            jnp.ones(n_rays, bool), jnp.full((n_rays,), -1.0, jnp.float32))
    if track_lod:
        init = init + (zeros, jnp.full((n_rays,), cone_spread0,
                                       jnp.float32))
    carry, _ = jax.lax.scan(bounce, init, (u, u_env))
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive, prev_pdf) = carry[:14]
    hit = _intersect_soa(rox, roy, roz, rdx, rdy, rdz)[0]
    miss = alive & ~hit
    mr, mg, mb, pdf_env_fin = em.eval_with_pdf(rdx, rdy, rdz)
    w_mis = jnp.where(prev_pdf < 0.0, 1.0,
                      power_heuristic(prev_pdf, pdf_env_fin))
    ra_r = ra_r + jnp.where(miss, th_r * mr * w_mis, 0.0)
    ra_g = ra_g + jnp.where(miss, th_g * mg * w_mis, 0.0)
    ra_b = ra_b + jnp.where(miss, th_b * mb * w_mis, 0.0)
    radiance = jnp.stack([ra_r, ra_g, ra_b], -1)
    return radiance.reshape(spp, res, res, 3).mean(axis=0)


def _render_soa(infos, light_dir, light_rad, sky_rad, ro, rd, u,
                res: int, spp: int, dedup_ok: bool = True,
                cone_spread0: float = 0.0):
    """The fused-material render loop on flat (N,) component arrays:
    path state, intersection, tangent frames and both BSDF ops stay
    SoA end to end (no (N, 3) tiles in the hot loop). Semantics match
    the generic loop to f32 rounding; RNG layout is shared with it so
    the two paths integrate the same sample set.

    The FIRST bounce is spp-deduplicated: all spp copies of a pixel
    share the camera ray, so its intersection, tangent frame, shadow
    ray and NEE evaluation are computed once per pixel (P = N/spp
    lanes) and tiled — only the BSDF sampler (which consumes the
    per-copy random numbers) runs at full ray count. Values are
    bit-identical to the per-ray computation (same ops, same
    inputs)."""
    n_rays = rd.shape[0]
    tex_ctx = _texture_ctx(infos)
    track_lod = _needs_lod(infos)
    # (B, N, 2) -> (B, 2, N): slices of the minor-dim-2 layout are
    # strided AoS reads; transpose once outside the scan instead
    u = jnp.moveaxis(u, -1, 1)
    ldx, ldy, ldz = light_dir[0], light_dir[1], light_dir[2]
    lr_r, lr_g, lr_b = light_rad[0], light_rad[1], light_rad[2]
    sk_r, sk_g, sk_b = sky_rad[0], sky_rad[1], sky_rad[2]
    off = _EPS * 3.0

    def bounce(carry, u_b):
        if track_lod:
            # ray cone (width, spread) for texture LOD: width grows
            # linearly along the segment, spread widens at glossy
            # bounces by the sampled lane's roughness
            (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
             ra_r, ra_g, ra_b, alive, cw, cs) = carry
        else:
            (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
             ra_r, ra_g, ra_b, alive) = carry
            cw = cs = None
        hit, t, nx, ny, nz, is_sphere, px, py, pz = _intersect_soa(
            rox, roy, roz, rdx, rdy, rdz)
        if track_lod:
            cw = cw + cs * jnp.where(hit, t, 0.0)

        # miss -> sky
        miss = alive & ~hit
        ra_r = ra_r + jnp.where(miss, th_r * sk_r, 0.0)
        ra_g = ra_g + jnp.where(miss, th_g * sk_g, 0.0)
        ra_b = ra_b + jnp.where(miss, th_b * sk_b, 0.0)
        alive = alive & hit

        tx, ty, tz, bx, by, bz = _build_frame_soa(nx, ny, nz)
        # o = -rd and the light direction in the tangent frame
        ox = -(rdx * tx + rdy * ty + rdz * tz)
        oy = -(rdx * bx + rdy * by + rdz * bz)
        oz = -(rdx * nx + rdy * ny + rdz * nz)
        lx = ldx * tx + ldy * ty + ldz * tz
        ly = ldx * bx + ldy * by + ldz * bz
        lz = ldx * nx + ldy * ny + ldz * nz

        # next-event estimation toward the delta light
        sox, soy, soz = px + nx * off, py + ny * off, pz + nz * off
        s_hit = _intersect_soa(sox, soy, soz,
                               jnp.broadcast_to(ldx, sox.shape),
                               jnp.broadcast_to(ldy, sox.shape),
                               jnp.broadcast_to(ldz, sox.shape))[0]
        lit = ~s_hit

        pv, fres_fn = _resolve_scene(infos, tex_ctx, is_sphere, px, py,
                                     pz, cone_w=cw)
        fr, fg, fb, wr, wg, wb, ixl, iyl, izl, pdf = _fused_nee_and_sample(
            infos, pv, fres_fn, is_sphere, (lx, ly, lz), u_b[0], u_b[1],
            (ox, oy, oz))

        ok = alive & lit & (lz > 0.0) & (oz > 0.0)
        ra_r = ra_r + jnp.where(ok, th_r * lr_r * fr, 0.0)
        ra_g = ra_g + jnp.where(ok, th_g * lr_g * fg, 0.0)
        ra_b = ra_b + jnp.where(ok, th_b * lr_b * fb, 0.0)

        th_r = th_r * jnp.where(alive, wr, 1.0)
        th_g = th_g * jnp.where(alive, wg, 1.0)
        th_b = th_b * jnp.where(alive, wb, 1.0)
        alive = alive & (pdf > 0.0) & (izl > 0.0)

        # detached sampling (the Mitsuba-3 default): differentiate the
        # weights along FIXED paths — the reparameterization gradient
        # through sampled directions into the next intersection is
        # unbounded at grazing hits (d sqrt(disc) -> inf) and noisy
        ixl, iyl, izl = (jax.lax.stop_gradient(ixl),
                         jax.lax.stop_gradient(iyl),
                         jax.lax.stop_gradient(izl))

        # next segment: local_to_world + normalize
        wx = ixl * tx + iyl * bx + izl * nx
        wy = ixl * ty + iyl * by + izl * ny
        wz = ixl * tz + iyl * bz + izl * nz
        inrm = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-12))
        rdx = jnp.where(alive, wx * inrm, rdx)
        rdy = jnp.where(alive, wy * inrm, rdy)
        rdz = jnp.where(alive, wz * inrm, rdz)
        rox = jnp.where(alive, sox, rox)
        roy = jnp.where(alive, soy, roy)
        roz = jnp.where(alive, soz, roz)
        if track_lod:
            cs = cs + jnp.where(alive, jnp.minimum(pv[0], 1.0), 0.0)
            return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
                    ra_r, ra_g, ra_b, alive, cw, cs), None
        return (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
                ra_r, ra_g, ra_b, alive), None

    # ---- first bounce, spp-deduplicated over P = N/spp pixels.
    # Worth it when the NEE evaluation is expensive (a Beckmann side:
    # erf-based sigmas + Gaussian p22; measured +6%); for cheap-NEE
    # GGX-only scenes the tile copies outweigh the savings (-5%), so
    # those run bounce 1 through the ordinary scan body.
    # dedup is only an identity when all spp copies share the camera
    # ray — jittered sensors must not take it (dedup_ok=False)
    # NOTE: the bounce loop stays a lax.scan — unlike the solver's
    # micro-loop (DESIGN.md §2), unrolling the large bounce body was
    # measured 4x SLOWER (29 ms vs 7 ms/frame on the mixed scene):
    # the per-bounce program is big enough that XLA's per-iteration
    # fusion is the win, not cross-iteration fusion
    def run_bounces(carry, u_bounces):
        carry, _ = jax.lax.scan(bounce, carry, u_bounces)
        return carry

    dedup = (dedup_ok and spp > 1
             and any(info.family == "beck" for info in infos))
    if not dedup:
        ones = jnp.ones(n_rays, jnp.float32)
        zeros = jnp.zeros(n_rays, jnp.float32)
        init = (ro[..., 0], ro[..., 1], ro[..., 2],
                rd[..., 0], rd[..., 1], rd[..., 2],
                ones, ones, ones, zeros, zeros, zeros,
                jnp.ones(n_rays, bool))
        if track_lod:
            init = init + (zeros, jnp.full((n_rays,), cone_spread0,
                                           jnp.float32))
        carry = run_bounces(init, u)
        return _finish_soa(carry[:13], sk_r, sk_g, sk_b, res, spp)

    P = n_rays // spp
    tile = lambda a: jnp.tile(a, spp)
    rox_p, roy_p, roz_p = ro[:P, 0], ro[:P, 1], ro[:P, 2]
    rdx_p, rdy_p, rdz_p = rd[:P, 0], rd[:P, 1], rd[:P, 2]
    hit_p, t_p, nx_p, ny_p, nz_p, is_sph_p, px_p, py_p, pz_p = \
        _intersect_soa(rox_p, roy_p, roz_p, rdx_p, rdy_p, rdz_p)
    cw_p = (cone_spread0 * jnp.where(hit_p, t_p, 0.0)
            if track_lod else None)
    tx_p, ty_p, tz_p, bx_p, by_p, bz_p = _build_frame_soa(nx_p, ny_p, nz_p)
    ox_p = -(rdx_p * tx_p + rdy_p * ty_p + rdz_p * tz_p)
    oy_p = -(rdx_p * bx_p + rdy_p * by_p + rdz_p * bz_p)
    oz_p = -(rdx_p * nx_p + rdy_p * ny_p + rdz_p * nz_p)
    lx_p = ldx * tx_p + ldy * ty_p + ldz * tz_p
    ly_p = ldx * bx_p + ldy * by_p + ldz * bz_p
    lz_p = ldx * nx_p + ldy * ny_p + ldz * nz_p
    sox_p, soy_p, soz_p = (px_p + nx_p * off, py_p + ny_p * off,
                           pz_p + nz_p * off)
    s_hit_p = _intersect_soa(sox_p, soy_p, soz_p,
                             jnp.broadcast_to(ldx, sox_p.shape),
                             jnp.broadcast_to(ldy, sox_p.shape),
                             jnp.broadcast_to(ldz, sox_p.shape))[0]
    pv_p, fres_p = _resolve_scene(infos, tex_ctx, is_sph_p, px_p, py_p,
                                  pz_p, cone_w=cw_p)
    fr_p, fg_p, fb_p = _fused_nee_eval(infos, pv_p, fres_p, is_sph_p,
                                       (lx_p, ly_p, lz_p),
                                       (ox_p, oy_p, oz_p))
    # per-pixel radiance terms of bounce 1 (throughput = 1, all alive)
    ok_p = hit_p & ~s_hit_p & (lz_p > 0.0) & (oz_p > 0.0)
    ra1_r = jnp.where(~hit_p, sk_r, 0.0) + jnp.where(ok_p, lr_r * fr_p, 0.0)
    ra1_g = jnp.where(~hit_p, sk_g, 0.0) + jnp.where(ok_p, lr_g * fg_p, 0.0)
    ra1_b = jnp.where(~hit_p, sk_b, 0.0) + jnp.where(ok_p, lr_b * fb_p, 0.0)

    # the sampler consumes per-copy randoms: full ray count (the
    # per-pixel pvec/Fresnel tile with the other per-pixel values)
    alive1 = tile(hit_p)
    is_sph1 = tile(is_sph_p)
    o1 = (tile(ox_p), tile(oy_p), tile(oz_p))
    pv1t = jnp.tile(pv_p, (1, spp))
    fres1t = _make_fres_fn(infos, is_sph1, pv1t)
    wr1, wg1, wb1, ix1, iy1, iz1, pdf1 = _fused_sample(
        infos, pv1t, fres1t, is_sph1, u[0][0], u[0][1], o1)
    th_r = jnp.where(alive1, wr1, 1.0)
    th_g = jnp.where(alive1, wg1, 1.0)
    th_b = jnp.where(alive1, wb1, 1.0)
    alive1 = alive1 & (pdf1 > 0.0) & (iz1 > 0.0)
    # detached sampling — see the bounce body
    ix1, iy1, iz1 = (jax.lax.stop_gradient(ix1),
                     jax.lax.stop_gradient(iy1),
                     jax.lax.stop_gradient(iz1))
    wx = ix1 * tile(tx_p) + iy1 * tile(bx_p) + iz1 * tile(nx_p)
    wy = ix1 * tile(ty_p) + iy1 * tile(by_p) + iz1 * tile(ny_p)
    wz = ix1 * tile(tz_p) + iy1 * tile(bz_p) + iz1 * tile(nz_p)
    inrm1 = jax.lax.rsqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-12))
    rdx1 = jnp.where(alive1, wx * inrm1, tile(rdx_p))
    rdy1 = jnp.where(alive1, wy * inrm1, tile(rdy_p))
    rdz1 = jnp.where(alive1, wz * inrm1, tile(rdz_p))
    rox1 = jnp.where(alive1, tile(sox_p), tile(rox_p))
    roy1 = jnp.where(alive1, tile(soy_p), tile(roy_p))
    roz1 = jnp.where(alive1, tile(soz_p), tile(roz_p))

    init = (rox1, roy1, roz1, rdx1, rdy1, rdz1,
            th_r, th_g, th_b,
            tile(ra1_r), tile(ra1_g), tile(ra1_b),
            alive1)
    if track_lod:
        cs1 = cone_spread0 + jnp.where(
            alive1, jnp.minimum(pv1t[0], 1.0), 0.0)
        init = init + (tile(cw_p), cs1)
    carry = run_bounces(init, u[1:])
    return _finish_soa(carry[:13], sk_r, sk_g, sk_b, res, spp)


def _finish_soa(carry, sk_r, sk_g, sk_b, res: int, spp: int):
    """Terminate remaining live paths into the sky and assemble the
    image from the SoA carry."""
    (rox, roy, roz, rdx, rdy, rdz, th_r, th_g, th_b,
     ra_r, ra_g, ra_b, alive) = carry
    hit = _intersect_soa(rox, roy, roz, rdx, rdy, rdz)[0]
    miss = alive & ~hit
    ra_r = ra_r + jnp.where(miss, th_r * sk_r, 0.0)
    ra_g = ra_g + jnp.where(miss, th_g * sk_g, 0.0)
    ra_b = ra_b + jnp.where(miss, th_b * sk_b, 0.0)

    radiance = jnp.stack([ra_r, ra_g, ra_b], -1)
    return radiance.reshape(spp, res, res, 3).mean(axis=0)
