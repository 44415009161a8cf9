"""Render / LSQ-fit / parallel-integral / entry-point tests."""

import jax
import jax.numpy as jnp
import numpy as np

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.fit import lsq
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.models.lambert import Lambert
from dj_brdf_tpu.parallel import integrals
from dj_brdf_tpu.parallel.mesh import make_mesh
from dj_brdf_tpu.render.sphere import render_sphere


def test_render_sphere_image_and_gradients():
    dist = GGX()

    def forward(params, f0):
        fres = fresnel.Schlick(f0=f0)
        return render_sphere(lambda i, o: mf.evalp(dist, fres, params, i, o),
                             light_dir=(0.3, 0.4, 0.8), res=64)

    params = MicrofacetParams.elliptic(0.3, 0.1, 0.5)
    f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    img = jax.jit(forward)(params, f0)
    assert img.shape == (64, 64, 3)
    assert float(img.max()) > 0.1
    assert np.isfinite(np.asarray(img)).all()
    # corners outside the sphere are black
    assert float(img[0, 0].sum()) == 0.0

    g = jax.jit(jax.grad(lambda p, f: forward(p, f).sum(), argnums=(0, 1)))(
        params, f0)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_render_pixel_gradients_match_finite_differences():
    """Pixel-gradient correctness (BASELINE north_star): autodiff
    d(image)/d(alpha) vs central finite differences."""
    dist = GGX()
    fres = fresnel.Ideal()

    def image_sum(alpha):
        params = MicrofacetParams.pdfparams(alpha, alpha)
        return render_sphere(lambda i, o: mf.evalp(dist, fres, params, i, o),
                             light_dir=(0.2, 0.1, 0.97), res=32).sum()

    a0 = jnp.float32(0.4)
    g_ad = float(jax.grad(image_sum)(a0))
    eps = 1e-3
    g_fd = (float(image_sum(a0 + eps)) - float(image_sum(a0 - eps))) / (2 * eps)
    np.testing.assert_allclose(g_ad, g_fd, rtol=5e-3)


def test_lsq_recovers_ggx_parameters(rng):
    dist = GGX()
    true_params = MicrofacetParams.isotropic(0.25)
    true_f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    n = 4096
    i = from_spherical(jnp.asarray(rng.uniform(0.05, 1.45, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    o = from_spherical(jnp.asarray(rng.uniform(0.05, 1.45, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    target = mf.evalp(dist, fresnel.Schlick(f0=true_f0), true_params, i, o)

    params, fres, losses = lsq.fit_lsq(dist, i, o, target, steps=400, lr=5e-2)
    assert float(losses[-1]) < 1e-3
    np.testing.assert_allclose(float(params.ax), 0.25, rtol=0.05)
    np.testing.assert_allclose(np.asarray(fres.f0), np.asarray(true_f0),
                               atol=0.05)


def test_furnace_integral_lambert():
    lam = Lambert(reflectance=jnp.asarray([0.8, 0.8, 0.8], jnp.float32))
    o = from_spherical(jnp.asarray([0.3, 0.9]), jnp.asarray([0.0, 1.0]))
    vals = integrals.furnace_integral(lam.evalp, o, n_theta=128, n_phi=256)
    np.testing.assert_allclose(np.asarray(vals), 0.8, rtol=2e-2)


def test_furnace_integral_sharded_matches_unsharded():
    mesh = make_mesh(8)
    dist = GGX()
    fres = fresnel.Ideal()
    params = MicrofacetParams.isotropic(0.5)
    evalp_fn = lambda i, o: mf.evalp(dist, fres, params, i, o)
    o = from_spherical(jnp.linspace(0.1, 1.4, 16), jnp.zeros(16))
    plain = integrals.furnace_integral(evalp_fn, o)
    sharded = integrals.furnace_integral(evalp_fn, o, mesh=mesh)
    np.testing.assert_allclose(np.asarray(plain), np.asarray(sharded),
                               rtol=1e-5)
    # energy conservation
    assert float(jnp.max(sharded)) <= 1.0 + 1e-2


def test_graft_entry_and_dryrun():
    import __graft_entry__ as g
    fn, args = g.entry()
    img = jax.jit(fn)(*args)
    assert img.shape == (256, 256, 3)
    assert np.isfinite(np.asarray(img)).all()
    g.dryrun_multichip(8)


def test_sharded_aniso_power_iteration_matches_host():
    from dj_brdf_tpu.fit import tabular, tabular_aniso
    from dj_brdf_tpu.parallel import power

    elev, azim = 9, 16  # n = 8*16 = 128, divisible by 8 devices
    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(0.5, 0.25, 0.6))
    host = np.asarray(tabular_aniso.power_iteration_p22(
        tabular_aniso.kernel_matrix(eval_fn, elev, azim), elev, azim))
    mesh = make_mesh(8)
    sharded = np.asarray(power.aniso_p22_sharded(eval_fn, elev, azim, mesh))
    # sharded path runs f32 vs the host's f64 power iteration
    np.testing.assert_allclose(sharded, host, rtol=1e-4, atol=1e-4 * host.max())


def test_device_f32_power_path_matches_host_f64():
    """The on-device f32 power iteration (fit/tabular_aniso.py::
    _device_power_table) is the branch every production-size build
    takes (n > HOST_F64_MAX_N); build the same 45x45 table through it
    and through the reference-style host-f64 path and require <=1e-4
    relative agreement post-normalization (dj_brdf.h:2467-2480)."""
    from dj_brdf_tpu.fit import tabular, tabular_aniso

    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(0.4, 0.15, 0.35))
    host, _ = tabular_aniso.build_tabular_anisotropic(
        eval_fn, 45, 45, power="host")
    dev, _ = tabular_aniso.build_tabular_anisotropic(
        eval_fn, 45, 45, power="device")
    hp = np.asarray(host.p22)
    np.testing.assert_allclose(np.asarray(dev.p22), hp, rtol=1e-4,
                               atol=1e-4 * hp.max())
    hs = np.asarray(host.sigma)
    np.testing.assert_allclose(np.asarray(dev.sigma), hs, rtol=1e-4,
                               atol=1e-6)


def test_device_power_table_finite_at_90x90():
    """Production-size stage 1 through the device-f32 path: the
    8010^2 kernel matrix + 4 unnormalized matvecs stay finite and
    strictly positive in the interior (f32 headroom check — the
    iterate grows as lambda_max^4)."""
    from dj_brdf_tpu.fit import tabular, tabular_aniso

    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(0.3, 0.15, 0.4))
    A = tabular_aniso.kernel_matrix(eval_fn, 90, 90, dtype=jnp.float32)
    table = tabular_aniso._device_power_table(A, 90, 90)
    t = np.asarray(table)
    assert t.shape == (90, 90)
    assert np.isfinite(t).all()
    assert (t[:, :-1] > 0.0).all()  # interior positive; edge column 0
    assert (t[:, -1] == 0.0).all()


def test_mesh_builder_matches_unsharded():
    """One-call multi-chip anisotropic extraction:
    build_tabular_anisotropic(mesh=...) == the unsharded builder,
    including stage 2 tables and the extracted Fresnel. n = 7*15 = 105
    is deliberately not a multiple of 8 devices, exercising the
    sharded power iteration's column padding."""
    from dj_brdf_tpu.fit import tabular, tabular_aniso

    elev, azim = 8, 15  # n = 105, not a multiple of 8 devices
    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(0.5, 0.25, 0.6))
    plain, fres0 = tabular_aniso.build_tabular_anisotropic(eval_fn, elev, azim)
    mesh = make_mesh(8)
    shard, fres1 = tabular_aniso.build_tabular_anisotropic(eval_fn, elev,
                                                           azim, mesh=mesh)
    # sharded stage 1 runs f32 vs the host's f64 power iteration
    for name in ("p22", "sigma", "pdf1", "cdf1", "qf1_table", "pdf2",
                 "cdf2", "qf2_table"):
        a = np.asarray(getattr(plain, name))
        b = np.asarray(getattr(shard, name))
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4 * a.max(),
                                   err_msg=name)
    np.testing.assert_allclose(np.asarray(fres1.points),
                               np.asarray(fres0.points), rtol=2e-3, atol=1e-4)


def test_path_tracer_basic_and_gradients():
    import dj_brdf_tpu as djt
    from dj_brdf_tpu.render.pathtrace import render

    def make_img(f0):
        gold = djt.MicrofacetMaterial(
            GGX(), fresnel.Schlick(f0=f0),
            MicrofacetParams.elliptic(0.3, 0.15, 0.4))
        floor = djt.CosineMaterial(
            model=djt.Lambert(reflectance=jnp.asarray([0.4, 0.4, 0.4])))
        return render(gold, floor, light_dir=(0.4, 0.5, 0.75),
                      light_radiance=(3.0, 3.0, 3.0),
                      sky_radiance=(0.3, 0.4, 0.5),
                      res=48, spp=4, max_bounces=3)

    f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    img = make_img(f0)
    assert img.shape == (48, 48, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert float(img.mean()) > 0.05
    # top corner pixels see the sky directly
    np.testing.assert_allclose(np.asarray(img[0, 0]), [0.3, 0.4, 0.5],
                               atol=1e-5)
    # differentiable w.r.t. material parameters
    g = jax.grad(lambda f: make_img(f).mean())(f0)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


def test_path_tracer_white_furnace_bound():
    """Sky-only illumination of perfectly white materials: radiance
    can never exceed the sky radiance (energy conservation through
    the sampler/weight chain)."""
    import dj_brdf_tpu as djt
    from dj_brdf_tpu.render.pathtrace import render
    white = djt.CosineMaterial(
        model=djt.Lambert(reflectance=jnp.asarray([1.0, 1.0, 1.0])))
    img = render(white, white, light_dir=(0.0, 0.0, 1.0),
                 light_radiance=(0.0, 0.0, 0.0),
                 sky_radiance=(1.0, 1.0, 1.0),
                 res=32, spp=8, max_bounces=4)
    assert float(img.max()) <= 1.0 + 1e-4
    # most of the frame should be close to the furnace value
    assert float(jnp.median(img)) > 0.6


def test_path_tracer_subpixel_jitter():
    """jitter=True anti-aliases: an edge pixel's jittered value lies
    within its unjittered 3x3 neighbourhood's range (it integrates the
    pixel footprint), while jitter=False stays the deterministic
    shared-camera-ray path (the per-sample bRec context
    of mitsuba/dj_brdf.cpp:342-439)."""
    from dj_brdf_tpu.render import materials, pathtrace

    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
    floor = materials.MicrofacetMaterial(
        dist=Beckmann(), fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        params=MicrofacetParams.isotropic(0.5))
    args = (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.asarray([4.0, 4.0, 4.0]), jnp.asarray([0.3, 0.35, 0.4]))
    kw = dict(res=32, spp=32, max_bounces=2)

    base = np.asarray(pathtrace.render(*args, **kw))
    again = np.asarray(pathtrace.render(*args, **kw, jitter=False))
    np.testing.assert_array_equal(base, again)  # flag off = same path

    jit = np.asarray(pathtrace.render(*args, **kw, jitter=True))
    assert np.isfinite(jit).all()
    assert np.abs(jit - base).max() > 1e-4  # jitter actually engaged

    # strongest horizontal luminance edge away from the border
    lum = base.mean(-1)
    edge = np.abs(np.diff(lum, axis=1))[2:-2, 2:-2]
    r, c = np.unravel_index(np.argmax(edge), edge.shape)
    r, c = r + 2, c + 3  # pixel right of the edge, in full-image coords
    nbhd = lum[r - 1:r + 2, c - 1:c + 2]
    span = nbhd.max() - nbhd.min()
    jl = jit.mean(-1)[r, c]
    assert nbhd.min() - 0.1 * span <= jl <= nbhd.max() + 0.1 * span


def test_path_tracer_sharded_matches_unsharded():
    """mesh-sharded path trace == single-device path trace (rays shard
    over the data axis, materials replicate)."""
    from dj_brdf_tpu.render import materials, pathtrace

    sphere = materials.MicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
        params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
    floor = materials.MicrofacetMaterial(
        dist=Beckmann(), fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
        params=MicrofacetParams.isotropic(0.5))
    args = (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
            jnp.asarray([4.0, 4.0, 4.0]), jnp.asarray([0.3, 0.35, 0.4]))

    img0 = pathtrace.render(*args, res=32, spp=8, max_bounces=2)
    mesh = make_mesh(8)
    img1 = pathtrace.render(*args, res=32, spp=8, max_bounces=2, mesh=mesh)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               rtol=1e-5, atol=1e-6)


def test_path_tracer_fused_dispatch_matches_generic(monkeypatch):
    """The fused per-ray material dispatch
    renders the same image as the generic both-materials path, for
    both a mixed-family (GGX sphere + Beckmann floor) and a
    same-family (per-ray pvec select) scene."""
    from dj_brdf_tpu.render import materials, pathtrace

    def scene(floor_dist, floor_alpha):
        sphere = materials.MicrofacetMaterial(
            dist=GGX(), fres=fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3])),
            params=MicrofacetParams.elliptic(0.3, 0.15, 0.7))
        floor = materials.MicrofacetMaterial(
            dist=floor_dist,
            fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(floor_alpha))
        return (sphere, floor, jnp.asarray([0.3, 0.4, 0.8], jnp.float32),
                jnp.asarray([4.0, 4.0, 4.0]), jnp.asarray([0.3, 0.35, 0.4]))

    for floor_dist in (Beckmann(), GGX()):
        args = scene(floor_dist, 0.5)
        img_fast = pathtrace.render(*args, res=32, spp=4, max_bounces=2)
        with monkeypatch.context() as mp:
            mp.setattr(pathtrace, "_fused_info", lambda m: None)
            jax.clear_caches()  # dispatch is decided at trace time
            img_generic = pathtrace.render(*args, res=32, spp=4,
                                           max_bounces=2)
        np.testing.assert_allclose(np.asarray(img_fast),
                                   np.asarray(img_generic),
                                   rtol=2e-3, atol=2e-4)
    jax.clear_caches()


def test_path_tracer_soa_path_gradients():
    """The SoA fused render loop (incl. the dual-family kernel and the
    unrolled Halley slope solve) is differentiable w.r.t. material
    parameters — finite, nonzero pixel gradients on both scenes."""
    from dj_brdf_tpu.render import materials, pathtrace

    def make_img(f0, floor_dist):
        sphere = materials.MicrofacetMaterial(
            dist=GGX(), fres=fresnel.Schlick(f0=f0),
            params=MicrofacetParams.elliptic(0.3, 0.15, 0.4))
        floor = materials.MicrofacetMaterial(
            dist=floor_dist,
            fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(0.5))
        return pathtrace.render(sphere, floor, (0.4, 0.5, 0.75),
                                (3.0, 3.0, 3.0), (0.3, 0.4, 0.5),
                                res=24, spp=2, max_bounces=2)

    f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    for floor_dist in (Beckmann(), GGX()):
        g = jax.grad(lambda f: make_img(f, floor_dist).mean())(f0)
        g = np.asarray(g)
        assert np.isfinite(g).all()
        assert np.abs(g).max() > 0
