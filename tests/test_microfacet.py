"""Microfacet framework invariants: normalization, projected area,
white furnace, sampling/pdf consistency, reciprocity, gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.core import math as vm
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import (
    MicrofacetParams, ellipse_to_pdfparams, pdfparams_to_ellipse)

DISTS = [GGX(), Beckmann()]
IDS = ["ggx", "beckmann"]


def hemi_dirs(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:, 2] = np.abs(v[:, 2])
    v[v[:, 2] < 5e-2, 2] = 5e-2
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.asarray(v, jnp.float32)


def test_params_roundtrip():
    a1, a2, phi_a = 0.8, 0.2, 0.7
    ax, ay, rho = ellipse_to_pdfparams(jnp.float32(a1), jnp.float32(a2),
                                       jnp.float32(phi_a))
    b1, b2, psi = pdfparams_to_ellipse(ax, ay, rho)
    # ellipse radii are recovered (angle can differ by symmetry)
    np.testing.assert_allclose(sorted([float(b1), float(b2)]),
                               sorted([a1, a2]), atol=1e-5)
    cx, cy, crho = ellipse_to_pdfparams(b1, b2, psi)
    np.testing.assert_allclose([cx, cy, crho], [ax, ay, rho], atol=1e-5)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_p22_std_normalized(dist):
    # integral of p22 over slope plane == 1 (polar quadrature)
    r = jnp.linspace(0.0, 60.0, 60001)
    vals = dist.p22_radial(r * r) * r
    integral = 2.0 * jnp.pi * jnp.trapezoid(vals, r)
    np.testing.assert_allclose(float(integral), 1.0, rtol=2e-3)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_sigma_std_normal_incidence(dist):
    np.testing.assert_allclose(float(dist.sigma_std_radial(jnp.float32(1.0))),
                               1.0, atol=1e-6)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_sigma_std_matches_quadrature(dist):
    # sigma(k) = int <k,h>+ D(h) dh; in the standard frame with slopes:
    # sigma(k) = int max(0, kz - kx x - ky y) p22(x,y) dx dy
    # polar tan-warped quadrature handles the GGX 1/r^4 slope tails
    nt, np_ = 2048, 512
    t = (jnp.arange(nt, dtype=jnp.float64) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_, dtype=jnp.float64) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(t, phi)
    r = jnp.tan(T)
    jac = r / jnp.cos(T) ** 2  # r dr = tan sec^2 dt
    dt = jnp.pi / 2 / nt
    dphi = 2 * jnp.pi / np_
    for cos_t in [0.3, 0.6, 0.9]:
        sin_t = np.sqrt(1 - cos_t ** 2)
        k = jnp.asarray([sin_t, 0.0, cos_t], jnp.float32)
        proj = jnp.maximum(0.0, cos_t - sin_t * r * jnp.cos(P))
        integ = float(jnp.sum(proj * dist.p22_std(r * jnp.cos(P), r * jnp.sin(P))
                              * jac) * dt * dphi)
        got = float(dist.sigma_std(k))
        np.testing.assert_allclose(got, integ, rtol=5e-3)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_ndf_slope_normalization_warped(dist):
    # int D(h) cos(theta_h) dh = 1 for any elliptic params
    params = MicrofacetParams.elliptic(0.5, 0.15, 0.9)
    nt, np_ = 512, 256
    theta = (jnp.arange(nt) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(theta, phi)
    h = vm.from_spherical(T, P)
    d = mf.ndf(dist, params, h)
    integ = jnp.sum(d * jnp.cos(T) * jnp.sin(T)) * (jnp.pi / 2 / nt) * (2 * jnp.pi / np_)
    np.testing.assert_allclose(float(integ), 1.0, rtol=5e-3)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_white_furnace_vndf(dist):
    # int vndf(h, k) dh = 1 (visible normals normalize to 1)
    params = MicrofacetParams.elliptic(0.6, 0.25, 0.4)
    k = jnp.asarray([0.45, -0.3, np.sqrt(1 - 0.45**2 - 0.3**2)], jnp.float32)
    nt, np_ = 512, 256
    theta = (jnp.arange(nt) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(theta, phi)
    h = vm.from_spherical(T, P)
    v = mf.vndf(dist, params, h, k)
    integ = jnp.sum(v * jnp.sin(T)) * (jnp.pi / 2 / nt) * (2 * jnp.pi / np_)
    np.testing.assert_allclose(float(integ), 1.0, rtol=1e-2)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_reciprocity(dist, rng):
    params = MicrofacetParams.elliptic(0.7, 0.3, 0.2)
    fres = fresnel.Ideal()
    i = hemi_dirs(rng, 256)
    o = hemi_dirs(rng, 256)
    f_io = mf.eval(dist, fres, params, i, o)
    f_oi = mf.eval(dist, fres, params, o, i)
    np.testing.assert_allclose(f_io, f_oi, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_energy_conservation_furnace(dist):
    # white furnace: int evalp(i, o) d_i <= 1 for ideal fresnel
    params = MicrofacetParams.isotropic(0.5)
    fres = fresnel.Ideal()
    nt, np_ = 256, 128
    theta = (jnp.arange(nt) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(theta, phi)
    i = vm.from_spherical(T, P)
    for theta_o in [0.1, 0.7, 1.3]:
        o = jnp.asarray([np.sin(theta_o), 0.0, np.cos(theta_o)], jnp.float32)
        vals = mf.evalp(dist, fres, params, i, jnp.broadcast_to(o, i.shape))
        integ = jnp.sum(vals[..., 0] * jnp.sin(T)) * (jnp.pi / 2 / nt) * (2 * jnp.pi / np_)
        assert float(integ) <= 1.0 + 1e-2


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_sample_pdf_consistency(dist, rng):
    # evalp(i,o)/pdf(i,o) == evalp_is weight for sampled i
    params = MicrofacetParams.elliptic(0.6, 0.3, 0.5)
    fres = fresnel.Ideal()
    n = 4096
    u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    theta_o = 0.8
    o = jnp.broadcast_to(
        jnp.asarray([np.sin(theta_o), 0.0, np.cos(theta_o)], jnp.float32), (n, 3))
    weight, i, pdf = mf.evalp_is(dist, fres, params, u1, u2, o)
    direct = mf.evalp(dist, fres, params, i, o)
    ratio = direct / jnp.maximum(pdf, 1e-12)[..., None]
    # samples whose reflection lands below the horizon get G=0 and pdf=0;
    # at these roughnesses/angles that's a modest fraction
    mask = np.asarray(pdf) > 1e-5
    assert mask.mean() > 0.75
    np.testing.assert_allclose(np.asarray(weight)[mask], np.asarray(ratio)[mask],
                               rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_sample_distribution_matches_vndf(dist, rng):
    # MC estimate: E[f(i)] under sample() ~= int f(i) pdf(i) di
    params = MicrofacetParams.isotropic(0.4)
    n = 200000
    u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    theta_o = 0.6
    o = jnp.broadcast_to(
        jnp.asarray([np.sin(theta_o), 0.0, np.cos(theta_o)], jnp.float32), (n, 3))
    i = mf.sample(dist, params, u1, u2, o)
    # some sampled i land below the horizon (pdf mass there is gated to 0),
    # so compare the above-horizon restriction of both estimates
    above = i[..., 2] > 0.0
    mass_mc = float(jnp.mean(above))
    mean_iz_mc = float(jnp.mean(jnp.where(above, i[..., 2], 0.0)))
    # quadrature of the pdf over the upper hemisphere
    nt, np_ = 512, 256
    theta = (jnp.arange(nt) + 0.5) / nt * (jnp.pi / 2)
    phi = (jnp.arange(np_) + 0.5) / np_ * (2 * jnp.pi)
    T, P = jnp.meshgrid(theta, phi)
    iq = vm.from_spherical(T, P)
    oq = jnp.broadcast_to(o[0], iq.shape)
    pdf_q = mf.pdf(dist, params, iq, oq)
    w = jnp.sin(T) * (jnp.pi / 2 / nt) * (2 * jnp.pi / np_)
    mass_q = float(jnp.sum(pdf_q * w))
    mean_iz_q = float(jnp.sum(pdf_q * jnp.cos(T) * w))
    np.testing.assert_allclose(mass_mc, mass_q, atol=0.02)
    np.testing.assert_allclose(mean_iz_mc, mean_iz_q, atol=0.02)


@pytest.mark.parametrize("dist", DISTS, ids=IDS)
def test_evalp_gradients_finite(dist, rng):
    params = MicrofacetParams.elliptic(0.5, 0.2, 0.3, txn=0.1, tyn=-0.05)
    fres = fresnel.Schlick(f0=jnp.asarray([0.9, 0.7, 0.4], jnp.float32))
    i = hemi_dirs(rng, 64)
    o = hemi_dirs(rng, 64)

    def loss(p, f):
        return jnp.sum(mf.evalp(dist, f, p, i, o))

    g_params, g_fres = jax.grad(loss, argnums=(0, 1))(params, fres)
    for leaf in jax.tree_util.tree_leaves((g_params, g_fres)):
        assert np.all(np.isfinite(np.asarray(leaf)))
    # roughness gradient should be nonzero
    assert abs(float(g_params.ax)) > 0


def test_noncentral_mean_normal_shifts_ndf_peak():
    dist = GGX()
    params = MicrofacetParams.pdfparams(0.1, 0.1, 0.0, txn=0.5, tyn=0.0)
    # NDF peak should be near h = normalize(-txn, -tyn, 1) = normalize(-0.5,0,1)
    n = vm.normalize(jnp.asarray([-0.5, 0.0, 1.0]))
    d_peak = mf.ndf(dist, params, n)
    d_up = mf.ndf(dist, params, jnp.asarray([0.0, 0.0, 1.0]))
    assert float(d_peak) > float(d_up)


def test_tabular_nmap_sampler_matches_source_distribution(rng):
    """The tabulated distribution's cdf/qf ("nmap") sampler should
    reproduce the source GGX's NDF-sampled half-vector statistics."""
    from dj_brdf_tpu import fresnel as fm
    from dj_brdf_tpu.fit import tabular as ft

    alpha = 0.4
    src = GGX()
    eval_fn = ft.microfacet_eval_fn(src, fm.Ideal(),
                                    MicrofacetParams.isotropic(alpha))
    tab, _ = ft.build_tabular(eval_fn, 90, shadow=False)

    n = 200000
    u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
    k = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))
    # sample slopes from the tabulated qf tables
    sx_t, sy_t = tab.sample_vp22_std(u1, u2, k)
    r_tab = jnp.sqrt(sx_t ** 2 + sy_t ** 2)
    # analytic GGX nmap sampling at the *fitted* roughness: the
    # tabulation pipeline carries its known bias, so compare against
    # the alpha it actually encodes
    from dj_brdf_tpu.fit import moments
    a_fit = float(moments.fit_ggx_parameters(tab).ax)
    r_ggx = src.qf_radial(u2) * a_fit
    # compare medians (heavy-tailed; mean diverges)
    np.testing.assert_allclose(float(jnp.median(r_tab)),
                               float(jnp.median(r_ggx)), rtol=0.05)


def test_aniso_moment_fits_vmap_over_table_batch():
    """The anisotropic moment fits are pure device computations:
    jit(vmap(fit)) over a stack of tables must match
    the per-table loop, and gradients must flow to the table."""
    from dj_brdf_tpu import fresnel as fm
    from dj_brdf_tpu.fit import moments, tabular as ft, tabular_aniso as fta

    dists = []
    for (a1, a2, phi_a) in [(0.5, 0.25, 0.6), (0.3, 0.3, 0.0)]:
        eval_fn = ft.microfacet_eval_fn(
            GGX(), fm.Ideal(), MicrofacetParams.elliptic(a1, a2, phi_a))
        d, _ = fta.build_tabular_anisotropic(eval_fn, 16, 16)
        dists.append(d)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *dists)

    from dj_brdf_tpu.fit.moments import (
        fit_beckmann_parameters_anisotropic as fit_b,
        fit_ggx_parameters_anisotropic as fit_g)
    for fit in (fit_b, fit_g):
        batched = jax.jit(jax.vmap(fit))(stacked)
        for k, d in enumerate(dists):
            single = fit(d)
            for f in ("ax", "ay", "rho", "txn", "tyn"):
                np.testing.assert_allclose(
                    float(getattr(batched, f)[k]), float(getattr(single, f)),
                    rtol=1e-5, atol=1e-6, err_msg=f"{fit.__name__}.{f}[{k}]")

    # gradients flow from the fitted alpha back to the p22 table
    def loss(p22):
        d = dists[0].replace(p22=p22) if hasattr(dists[0], "replace") else \
            type(dists[0])(**{**{f: getattr(dists[0], f)
                                 for f in ("p22", "sigma", "pdf1", "cdf1",
                                           "qf1_table", "pdf2", "cdf2",
                                           "qf2_table")}, "p22": p22})
        return fit_g(d).ax
    g = jax.grad(loss)(dists[0].p22)
    assert np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).sum()) > 0


def test_beckmann_qf2_implicit_gradient_matches_fd(rng):
    """The slope-domain solver differentiates by the implicit function
    theorem (ndf._qf2_root custom_jvp), never through the unrolled
    Halley steps — grads w.r.t. u and cos(theta_k) must match central
    finite differences of the solve."""
    from dj_brdf_tpu.microfacet.ndf import beckmann_qf2_slope_domain

    def f(u, c):
        s = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
        return beckmann_qf2_slope_domain(u, c, s)

    u = jnp.asarray(rng.uniform(0.05, 0.95, 64), jnp.float32)
    c = jnp.asarray(rng.uniform(0.1, 0.98, 64), jnp.float32)
    gu = jax.grad(lambda u: f(u, c).sum())(u)
    gc = jax.grad(lambda c: f(u, c).sum())(c)
    eps = 1e-3
    fdu = (np.asarray(f(u + eps, c)) - np.asarray(f(u - eps, c))) / (2 * eps)
    fdc = (np.asarray(f(u, c + eps)) - np.asarray(f(u, c - eps))) / (2 * eps)
    ru = np.abs(np.asarray(gu) - fdu) / (np.abs(fdu) + 1e-3)
    rc = np.abs(np.asarray(gc) - fdc) / (np.abs(fdc) + 1e-3)
    assert np.median(ru) < 1e-2 and (ru < 0.05).mean() > 0.95
    assert np.median(rc) < 2e-2 and (rc < 0.1).mean() > 0.9
