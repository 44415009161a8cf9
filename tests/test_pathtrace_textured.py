"""Integrator-orthogonal materials: textured roughness and LEAN maps
under the multi-bounce path tracer. In the reference
every material fetches its textures per shading point inside whatever
Mitsuba integrator runs (mitsuba/dj_brdf.cpp:353-357,
dj_beckmannconductor.cpp:280-428); here the fused SoA bounce loop
resolves per-hit (8, N) parameter vectors the kernels consume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
from dj_brdf_tpu.lean.lrep import Lrep
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.models.lambert import Lambert
from dj_brdf_tpu.render import materials, pathtrace
from dj_brdf_tpu.render.envmap import EnvMap
from dj_brdf_tpu.render.materials import (CosineMaterial,
                                          MicrofacetMaterial,
                                          TexturedMicrofacetMaterial)

GOLD_ETA = jnp.asarray([0.143, 0.375, 1.442], jnp.float32)
GOLD_K = jnp.asarray([3.983, 2.386, 1.603], jnp.float32)
F0 = fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32))


def _floor():
    return MicrofacetMaterial(
        dist=Beckmann(), fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        params=MicrofacetParams.isotropic(0.5))


def _render(sphere, floor, **kw):
    args = dict(res=24, spp=4, max_bounces=2)
    args.update(kw)
    return np.asarray(pathtrace.render(
        sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
        jnp.asarray([3.0, 3.0, 3.0]), jnp.asarray([0.2, 0.25, 0.3]),
        **args))


def _sun_sky(h=16, w=32):
    rng = np.random.default_rng(1)
    img = np.abs(rng.normal(1.0, 0.4, (h, w, 3))).astype(np.float32)
    img[3:5, 10:13] *= 40.0
    return EnvMap.build(jnp.asarray(img))


def test_constant_texture_matches_uniform():
    """A constant-valued alpha texture reproduces the uniform-material
    image (the done-criterion): per-hit fetch + elliptic
    conversion equals the uniform pvec to f32 rounding."""
    a1, a2, ang = 0.35, 0.15, 0.6
    uni = MicrofacetMaterial(dist=GGX(), fres=F0,
                             params=MicrofacetParams.elliptic(a1, a2, ang))
    tex = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0,
        alpha1=jnp.full((9, 13), a1, jnp.float32),
        alpha2=jnp.full((9, 13), a2, jnp.float32),
        alpha_angle=jnp.asarray(ang, jnp.float32))
    img_u = _render(uni, _floor())
    img_t = _render(tex, _floor())
    np.testing.assert_allclose(img_t, img_u, rtol=2e-5, atol=2e-6)


def test_constant_texture_matches_uniform_envmap():
    """Same under environment-map MIS transport — textures and
    --envmap compose (the matpreview combination)."""
    em = _sun_sky()
    a1 = 0.3
    uni = MicrofacetMaterial(dist=GGX(), fres=F0,
                             params=MicrofacetParams.isotropic(a1))
    tex = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0,
        alpha1=jnp.full((8, 8), a1, jnp.float32),
        alpha2=jnp.full((8, 8), a1, jnp.float32),
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    img_u = _render(uni, _floor(), envmap=em)
    img_t = _render(tex, _floor(), envmap=em)
    np.testing.assert_allclose(img_t, img_u, rtol=2e-5, atol=2e-6)


def test_lean_constant_maps_match_uniform():
    """A LEAN map with constant moments reproduces the uniform
    FilteredBeckmannMaterial under the path tracer (per-hit fetch ==
    uniform moments)."""
    E1, E2, E3, E4, E5 = 0.2, 0.1, 0.06, 0.04, 0.04
    base = MicrofacetParams.isotropic(0.2)
    uni = FilteredBeckmannMaterial(
        lean=Lrep(*(jnp.asarray(v, jnp.float32)
                    for v in (E1, E2, E3, E4, E5))),
        base_params=base, eta=GOLD_ETA, k=GOLD_K)
    tex = FilteredBeckmannMaterial(
        lean=Lrep(*(jnp.full((7, 11), v, jnp.float32)
                    for v in (E1, E2, E3, E4, E5))),
        base_params=base, eta=GOLD_ETA, k=GOLD_K)
    img_u = _render(uni, _floor())
    img_t = _render(tex, _floor())
    np.testing.assert_allclose(img_t, img_u, rtol=2e-5, atol=2e-6)


def test_uniform_lean_fused_matches_generic():
    """The uniform FilteredBeckmannMaterial now routes through the
    fused SoA loop (conductor Fresnel per lane); it must render the
    same image as the generic layered loop."""
    uni = FilteredBeckmannMaterial(
        lean=Lrep(*(jnp.asarray(v, jnp.float32)
                    for v in (0.2, 0.1, 0.06, 0.04, 0.04))),
        base_params=MicrofacetParams.isotropic(0.2),
        eta=GOLD_ETA, k=GOLD_K)
    img_fast = _render(uni, _floor())
    import pytest
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(pathtrace, "_fused_info", lambda m: None)
        jax.clear_caches()
        img_generic = _render(uni, _floor())
    finally:
        mp.undo()
        jax.clear_caches()
    np.testing.assert_allclose(img_fast, img_generic, rtol=2e-3, atol=2e-3)


def test_textured_roughness_varies_across_surface():
    """A two-band roughness texture produces visibly different
    highlights across the sphere (the fetch actually lands per-hit)."""
    amap = np.full((16, 32), 0.08, np.float32)
    amap[:, 16:] = 0.7
    tex = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0,
        alpha1=jnp.asarray(amap), alpha2=jnp.asarray(amap),
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    lo = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0,
        alpha1=jnp.full((16, 32), 0.08, jnp.float32),
        alpha2=jnp.full((16, 32), 0.08, jnp.float32),
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    img = _render(tex, _floor(), res=32, spp=8)
    img_lo = _render(lo, _floor(), res=32, spp=8)
    assert np.isfinite(img).all()
    # the two renders must differ exactly where the rough band lives
    assert np.abs(img - img_lo).max() > 0.01


def test_gradients_flow_to_texture_and_lean_leaves():
    """d(render)/d(alpha map) and d(render)/d(LEAN moment maps) are
    finite and nonzero — the inverse-rendering surface of the textured
    path (the done-criterion)."""
    em = _sun_sky()

    def loss(amap, e3map):
        sphere = TexturedMicrofacetMaterial(
            dist=GGX(), fres=F0, alpha1=amap, alpha2=amap,
            alpha_angle=jnp.asarray(0.0, jnp.float32))
        floor = FilteredBeckmannMaterial(
            lean=Lrep(E1=jnp.zeros_like(e3map), E2=jnp.zeros_like(e3map),
                      E3=e3map, E4=e3map, E5=jnp.zeros_like(e3map)),
            base_params=MicrofacetParams.isotropic(0.15),
            eta=GOLD_ETA, k=GOLD_K)
        img = pathtrace.render(
            sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.zeros(3), jnp.zeros(3), envmap=em,
            res=16, spp=2, max_bounces=2)
        return img.mean()

    amap0 = jnp.full((8, 8), 0.3, jnp.float32)
    e3map0 = jnp.full((6, 6), 0.05, jnp.float32)
    ga, ge = jax.grad(loss, argnums=(0, 1))(amap0, e3map0)
    ga, ge = np.asarray(ga), np.asarray(ge)
    assert np.isfinite(ga).all() and np.abs(ga).max() > 0
    assert np.isfinite(ge).all() and np.abs(ge).max() > 0


def test_matpreview_composition():
    """The full matpreview-grade scene: textured-
    alpha GGX sphere + LEAN-mapped Beckmann-conductor floor + envmap
    MIS lighting, one render call."""
    rng = np.random.default_rng(5)
    amap = jnp.asarray(rng.uniform(0.05, 0.6, (16, 16)), jnp.float32)
    e1 = jnp.asarray(rng.normal(0, 0.15, (12, 12)), jnp.float32)
    e2 = jnp.asarray(rng.normal(0, 0.15, (12, 12)), jnp.float32)
    lean = Lrep(E1=e1, E2=e2, E3=e1 * e1 + 0.02, E4=e2 * e2 + 0.02,
                E5=e1 * e2)
    sphere = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0, alpha1=amap, alpha2=amap,
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    floor = FilteredBeckmannMaterial(
        lean=lean, base_params=MicrofacetParams.isotropic(0.1),
        eta=GOLD_ETA, k=GOLD_K)
    img = _render(sphere, floor, envmap=_sun_sky(), res=32, spp=4,
                  max_bounces=3)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_partially_textured_lean_raises():
    """Mixed scalar/map LEAN moments have no sensible per-hit fetch;
    the dispatcher fails with a clear error instead of a broadcasting
    crash inside the scan."""
    mixed = FilteredBeckmannMaterial(
        lean=Lrep(E1=jnp.asarray(0.0), E2=jnp.asarray(0.0),
                  E3=jnp.full((4, 4), 0.05, jnp.float32),
                  E4=jnp.asarray(0.05), E5=jnp.asarray(0.0)),
        base_params=MicrofacetParams.isotropic(0.2),
        eta=GOLD_ETA, k=GOLD_K)
    with pytest.raises(ValueError, match="all scalar or all"):
        _render(mixed, _floor())


def test_textured_with_unfusable_floor_raises():
    """Textured materials need the fused SoA loop; pairing with a
    non-fused material raises a clear error instead of crashing."""
    tex = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0,
        alpha1=jnp.full((4, 4), 0.3, jnp.float32),
        alpha2=jnp.asarray(0.3, jnp.float32),
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    lamb = CosineMaterial(model=Lambert(
        reflectance=jnp.asarray([0.4, 0.4, 0.4])))
    with pytest.raises(ValueError, match="fused SoA path"):
        _render(tex, lamb)


def _lean_floor(lean, mip_lod=False, base=0.1):
    return FilteredBeckmannMaterial(
        lean=lean, base_params=MicrofacetParams.isotropic(base),
        eta=GOLD_ETA, k=GOLD_K, mip_lod=mip_lod)


def test_lean_mip_lod_constant_map_identity():
    """Constant moment maps make every pyramid level identical, so
    ray-cone LOD selection cannot change the image."""
    lean = Lrep(*(jnp.full((16, 16), v, jnp.float32)
                  for v in (0.2, 0.1, 0.06, 0.04, 0.04)))
    sphere = MicrofacetMaterial(
        dist=GGX(), fres=F0, params=MicrofacetParams.isotropic(0.3))
    a = _render(sphere, _lean_floor(lean, mip_lod=False), res=24, spp=4)
    b = _render(sphere, _lean_floor(lean, mip_lod=True), res=24, spp=4)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_lean_mip_lod_filters_minification():
    """The LEAN minification story inside the path tracer: a
    high-frequency slope checker on the floor. With ray-cone LOD the
    distant floor fetches averaged moments and converges to the
    fully-filtered (uniform) material's image; always-mip-0 fetches
    alias. err(LOD vs filtered) < err(mip0 vs filtered)."""
    h = w = 64
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    e1 = (0.8 * (2.0 * ((x + y) % 2) - 1.0)).astype(np.float32)
    zeros = np.zeros((h, w), np.float32)
    lean = Lrep(E1=jnp.asarray(e1), E2=jnp.asarray(zeros),
                E3=jnp.asarray(e1 * e1 + 0.02),
                E4=jnp.asarray(zeros + 0.02), E5=jnp.asarray(zeros))
    # the fully-filtered limit: pyramid top = moment means
    lean_uniform = Lrep(*(jnp.asarray(np.mean(m), jnp.float32)
                          for m in (e1, zeros, e1 * e1 + 0.02,
                                    zeros + 0.02, zeros)))
    sphere = MicrofacetMaterial(
        dist=GGX(), fres=F0, params=MicrofacetParams.isotropic(0.3))
    kw = dict(res=32, spp=16, max_bounces=2)
    img_ref = _render(sphere, _lean_floor(lean_uniform), **kw)
    img_lod = _render(sphere, _lean_floor(lean, mip_lod=True), **kw)
    img_m0 = _render(sphere, _lean_floor(lean, mip_lod=False), **kw)
    err_lod = np.abs(img_lod - img_ref).mean()
    err_m0 = np.abs(img_m0 - img_ref).mean()
    assert err_lod < err_m0, (err_lod, err_m0)
    # and the LOD render is genuinely close to the filtered limit
    assert err_lod < 0.6 * err_m0, (err_lod, err_m0)


def test_lean_mip_lod_gradients():
    """Gradients flow through whichever pyramid level was fetched
    back to the base moment maps."""
    e3 = jnp.full((8, 8), 0.05, jnp.float32)

    def loss(e3map):
        floor = _lean_floor(Lrep(E1=jnp.zeros_like(e3map),
                                 E2=jnp.zeros_like(e3map),
                                 E3=e3map, E4=e3map,
                                 E5=jnp.zeros_like(e3map)),
                            mip_lod=True)
        sphere = MicrofacetMaterial(
            dist=GGX(), fres=F0, params=MicrofacetParams.isotropic(0.3))
        img = pathtrace.render(
            sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.asarray([3.0, 3.0, 3.0]), jnp.asarray([0.2, 0.2, 0.2]),
            res=16, spp=2, max_bounces=2)
        return img.mean()

    g = np.asarray(jax.grad(loss)(e3))
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def _small_tabular():
    from dj_brdf_tpu.fit import tabular
    from dj_brdf_tpu.microfacet import brdf as mf

    def eval_fn(i, o):
        return mf.eval(GGX(), fresnel.Schlick(
            f0=jnp.asarray([0.9, 0.6, 0.3])),
            MicrofacetParams.isotropic(0.3), i, o)

    return tabular.build_tabular(eval_fn, 16)


def test_uvmapped_tabular_constant_matches_uniform():
    """UVMappedMaterial with constant alpha maps over a TABULAR NDF
    reproduces the uniform tabular material under the path tracer —
    the dj_brdf plugin's distribution="tabular" textured front end
    inside any integrator (mitsuba/dj_brdf.cpp:208-233, 353-357)."""
    from dj_brdf_tpu.render.materials import UVMappedMaterial
    tab, tab_fres = _small_tabular()
    uni = MicrofacetMaterial(dist=tab, fres=tab_fres,
                             params=MicrofacetParams.standard())
    tex = UVMappedMaterial(dist=tab, fres=tab_fres,
                           alpha1=jnp.ones((5, 7), jnp.float32),
                           alpha2=jnp.ones((5, 7), jnp.float32),
                           alpha_angle=jnp.asarray(0.0, jnp.float32))
    lamb = CosineMaterial(model=Lambert(
        reflectance=jnp.asarray([0.4, 0.4, 0.4])))
    img_u = _render(uni, lamb, res=16, spp=2)
    img_t = _render(tex, lamb, res=16, spp=2)
    np.testing.assert_allclose(img_t, img_u, rtol=2e-5, atol=2e-6)


def test_uvmapped_tabular_envmap_and_gradients():
    """Textured tabular + envmap MIS compose through the generic
    loop; gradients flow to the alpha texture."""
    from dj_brdf_tpu.render.materials import UVMappedMaterial
    tab, tab_fres = _small_tabular()
    em = _sun_sky(8, 16)
    lamb = CosineMaterial(model=Lambert(
        reflectance=jnp.asarray([0.4, 0.4, 0.4])))

    def loss(amap):
        tex = UVMappedMaterial(dist=tab, fres=tab_fres, alpha1=amap,
                               alpha2=amap,
                               alpha_angle=jnp.asarray(0.0, jnp.float32))
        img = pathtrace.render(
            tex, lamb, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.zeros(3), jnp.zeros(3), envmap=em,
            res=12, spp=2, max_bounces=2)
        return img.mean(), img

    amap0 = jnp.full((5, 5), 0.7, jnp.float32)
    (val, img), g = jax.value_and_grad(loss, has_aux=True)(amap0)
    assert np.isfinite(np.asarray(img)).all() and float(val) > 0
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_textured_sharded_matches_unsharded():
    """The full textured composition (alpha-textured sphere + LEAN
    floor + envmap MIS + ray-cone LOD) under a data-axis mesh sharding
    == the unsharded render: rays shard, texture/emitter tables
    replicate, and the threefry stream is partition-invariant."""
    from dj_brdf_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(9)
    em = _sun_sky()
    amap = jnp.asarray(rng.uniform(0.1, 0.5, (8, 8)), jnp.float32)
    sphere = TexturedMicrofacetMaterial(
        dist=GGX(), fres=F0, alpha1=amap, alpha2=amap,
        alpha_angle=jnp.asarray(0.0, jnp.float32))
    e1 = jnp.asarray(rng.normal(0, 0.1, (8, 8)), jnp.float32)
    floor = FilteredBeckmannMaterial(
        lean=Lrep(E1=e1, E2=e1, E3=e1 * e1 + 0.02, E4=e1 * e1 + 0.02,
                  E5=e1 * e1),
        base_params=MicrofacetParams.isotropic(0.1),
        eta=GOLD_ETA, k=GOLD_K, mip_lod=True)
    args = (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.zeros(3), jnp.zeros(3))
    kw = dict(res=16, spp=8, max_bounces=2, envmap=em)
    img0 = np.asarray(pathtrace.render(*args, **kw))
    img1 = np.asarray(pathtrace.render(*args, mesh=make_mesh(8), **kw))
    np.testing.assert_allclose(img1, img0, rtol=1e-5, atol=1e-6)
