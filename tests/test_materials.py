"""Renderer front-end materials and the spherical-caps sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.oracle as orc
from dj_brdf_tpu import fresnel
from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX, GGXSphericalCaps
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.render.materials import (CosineMaterial, MeasuredMaterial,
                                          MicrofacetMaterial, eval_hd)
from dj_brdf_tpu.models.lambert import Lambert


def test_spherical_caps_matches_reference_sampler(rng):
    """Same VNDF: moments of sampled directions agree between the
    reference's qf2/qf3 route and the spherical-caps sampler."""
    params = MicrofacetParams.elliptic(0.5, 0.2, 0.7)
    n = 400000
    u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    o = jnp.broadcast_to(jnp.asarray([0.5, 0.1, 0.8602], jnp.float32), (n, 3))
    i_ref = mf.sample(GGX(), params, u1, u2, o)
    i_cap = mf.sample(GGXSphericalCaps(), params, u1, u2, o)
    for axis in range(3):
        np.testing.assert_allclose(float(i_ref[:, axis].mean()),
                                   float(i_cap[:, axis].mean()), atol=5e-3)
        np.testing.assert_allclose(float((i_ref[:, axis] ** 2).mean()),
                                   float((i_cap[:, axis] ** 2).mean()),
                                   atol=5e-3)
    # pdf is the same function; weight consistency holds for caps too
    w, i, pdf = mf.evalp_is(GGXSphericalCaps(), fresnel.Ideal(), params,
                            u1[:4096], u2[:4096], o[:4096])
    direct = mf.evalp(GGXSphericalCaps(), fresnel.Ideal(), params,
                      i, o[:4096])
    mask = np.asarray(pdf) > 1e-5
    np.testing.assert_allclose(
        np.asarray(w)[mask],
        np.asarray(direct / jnp.maximum(pdf, 1e-12)[..., None])[mask],
        rtol=2e-2, atol=2e-3)


def _mc_reflectance(mat, o, n, seed=0):
    """MC estimate of the directional albedo int evalp d_i via the
    material's own importance sampler."""
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (n, 2))
    ob = jnp.broadcast_to(o, (n, 3))
    w, _, _ = mat.evalp_is(u[:, 0], u[:, 1], ob)
    return np.asarray(w.mean(axis=0))


def test_measured_material_is_unbiased(rng):
    """dj_merl pattern: proxy-IS estimate of albedo matches quadrature."""
    true_params = MicrofacetParams.isotropic(0.35)
    model = MicrofacetMaterial(GGX(), fresnel.Ideal(), true_params)
    # wrap the *eval* in a measured material with a deliberately
    # mismatched proxy (fit would give ~0.35; use 0.5 to stress IS)
    meas = MeasuredMaterial(model=model,
                            proxy_params=MicrofacetParams.isotropic(0.5),
                            proxy_dist=GGX())
    o = jnp.asarray([0.3, 0.0, 0.954], jnp.float32)
    est = _mc_reflectance(meas, o, 400000)

    # quadrature ground truth
    nt, np_ = 256, 128
    theta = (jnp.arange(nt) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(theta, phi)
    iq = from_spherical(T, P)
    vals = model.evalp(iq, jnp.broadcast_to(o, iq.shape))
    quad = np.asarray(jnp.sum(vals * jnp.sin(T)[..., None], axis=(0, 1))
                      * (jnp.pi / 2 / nt) * (2 * jnp.pi / np_))
    np.testing.assert_allclose(est, quad, rtol=0.05)


def test_cosine_material_is_unbiased():
    lam = Lambert(reflectance=jnp.asarray([0.6, 0.4, 0.2], jnp.float32))
    mat = CosineMaterial(model=lam)
    o = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    est = _mc_reflectance(mat, o, 100000)
    np.testing.assert_allclose(est, [0.6, 0.4, 0.2], rtol=0.02)


def test_eval_hd_roundtrip():
    model = MicrofacetMaterial(GGX(), fresnel.Ideal(),
                               MicrofacetParams.isotropic(0.4))
    h = jnp.asarray([0.1, 0.05, 0.9937], jnp.float32)
    d = jnp.asarray([0.3, 0.0, 0.954], jnp.float32)
    from dj_brdf_tpu.core.math import hd_to_io
    i, o = hd_to_io(h, d)
    want = model.evalp(i, o) / i[..., 2:3]
    got = eval_hd(model, h, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


@pytest.mark.skipif(not orc.available(), reason="no C++ oracle")
def test_autodiff_gradient_matches_oracle_finite_differences():
    """BASELINE north-star: d(evalp)/d(roughness) by autodiff vs
    central finite differences of the *C++ reference* evalp."""
    eps = 2e-3
    a0 = 0.4
    up = orc.run_floats("evalp", "ggx", a0 + eps, a0 + eps, 0.0, 0.0, 0.0)
    dn = orc.run_floats("evalp", "ggx", a0 - eps, a0 - eps, 0.0, 0.0, 0.0)
    fd = (up[:, 0] - dn[:, 0]) / (2 * eps)

    i, o = orc.evalp_grid_pairs()

    def f(a):
        params = MicrofacetParams.elliptic(a, a, 0.0)
        return mf.evalp(GGX(), fresnel.Ideal(), params,
                        jnp.asarray(i), jnp.asarray(o))[:, 0]

    ad = np.asarray(jax.jacfwd(f)(jnp.float32(a0)))
    # compare where the finite difference is well-conditioned
    scale = np.abs(fd) + 1e-2
    np.testing.assert_allclose(ad / scale, fd / scale, atol=5e-2)


def test_microfacet_material_fused_dispatch():
    """MicrofacetMaterial.evalp_is routes uniform GGX/Beckmann+Schlick
    through the fused SoA kernels and falls back for textured params /
    other Fresnels — both paths agreeing numerically."""
    import numpy as np
    from dj_brdf_tpu.microfacet.ndf import Beckmann, GGX
    from dj_brdf_tpu.microfacet import brdf as mf

    n = 4096
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n,))
    u2 = jax.random.uniform(k2, (n,))
    o = jnp.broadcast_to(jnp.asarray([0.25, -0.1, 0.96]), (n, 3))
    params = MicrofacetParams.elliptic(0.4, 0.2, 0.3)
    fres = fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32))

    for dist in (GGX(), Beckmann()):
        m = MicrofacetMaterial(dist=dist, fres=fres, params=params)
        assert m._fused_pvec() is not None
        w, i, p = m.evalp_is(u1, u2, o)
        w2, i2, p2 = mf.evalp_is(dist, fres, params, u1, u2, o)
        ok = np.isclose(np.asarray(w), np.asarray(w2),
                        rtol=5e-4, atol=5e-5).mean()
        assert ok > 0.999

    # textured params -> fallback
    tex = MicrofacetParams.elliptic(jnp.full((8, 8), 0.4), 0.2, 0.3)
    mt = MicrofacetMaterial(dist=GGX(), fres=fres, params=tex)
    assert mt._fused_pvec() is None
    # non-Schlick fresnel -> fallback
    mi = MicrofacetMaterial(dist=GGX(), fres=fresnel.Ideal(), params=params)
    assert mi._fused_pvec() is None


def test_fallback_matches_fused_at_horizon_edge():
    """A material renders bit-consistently whichever evalp_is path
    dispatches it: below-mean-normal-horizon receivers get
    weight = pdf = 0 on BOTH the fused and the layered fallback path
    (the reference's arbitrary up-sample, dj_brdf.h:1677-1678, is
    suppressed identically)."""
    import numpy as np
    from dj_brdf_tpu.microfacet.ndf import GGX

    n = 64
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n,))
    u2 = jax.random.uniform(k2, (n,))
    # strong mean-normal offset: receivers near grazing fall below the
    # warped horizon c(o) = o.z - o.x txn - o.y tyn <= 0
    params = MicrofacetParams.pdfparams(0.3, 0.3, 0.0, txn=2.0, tyn=0.0)
    fres = fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32))
    o = jnp.broadcast_to(jnp.asarray([0.9, 0.0, 0.2]), (n, 3))
    o = o / jnp.linalg.norm(o[0])

    fused = MicrofacetMaterial(dist=GGX(), fres=fres, params=params)
    assert fused._fused_pvec() is not None
    w_f, _, p_f = fused.evalp_is(u1, u2, o)

    # same material, forced down the fallback path via a per-pixel
    # (but constant) roughness texture
    tex_params = MicrofacetParams(
        ax=jnp.full((n,), float(params.ax)), ay=params.ay, rho=params.rho,
        txn=params.txn, tyn=params.tyn)
    fallback = MicrofacetMaterial(dist=GGX(), fres=fres, params=tex_params)
    assert fallback._fused_pvec() is None
    w_l, _, p_l = fallback.evalp_is(u1, u2, o)

    # this receiver is below the warped horizon: both paths zero out
    assert float(jnp.abs(w_f).max()) == 0.0
    assert float(jnp.abs(p_f).max()) == 0.0
    assert float(jnp.abs(w_l).max()) == 0.0
    assert float(jnp.abs(p_l).max()) == 0.0
