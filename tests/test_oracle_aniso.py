"""Anisotropic tabulation parity vs the C++ oracle: p22/sigma tables,
sampling-table queries, evalp through the tabulated BRDF, and the
5-moment anisotropic fits."""

import jax.numpy as jnp
import numpy as np
import pytest

import tests.oracle as orc
from dj_brdf_tpu import fresnel
from dj_brdf_tpu.fit import moments, tabular, tabular_aniso
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams

pytestmark = pytest.mark.skipif(not orc.available(), reason="no C++ oracle")

ELEV, AZIM = 16, 16


@pytest.fixture(scope="module", params=["beckmann", "ggx"])
def case(request):
    name = request.param
    a1, a2, phi_a = 0.5, 0.25, 0.6
    golden = orc.run_sections("tabular_aniso", name, a1, a2, phi_a, ELEV, AZIM)
    dist_in = {"ggx": GGX(), "beckmann": Beckmann()}[name]
    eval_fn = tabular.microfacet_eval_fn(
        dist_in, fresnel.Ideal(), MicrofacetParams.elliptic(a1, a2, phi_a))
    ours, fres = tabular_aniso.build_tabular_anisotropic(eval_fn, ELEV, AZIM)
    return golden, ours, fres


def test_p22_table(case):
    golden, ours, _ = case
    got = np.asarray(ours.p22).reshape(-1)
    np.testing.assert_allclose(got, golden["p22"], rtol=1e-2, atol=1e-8)


def test_sigma_table(case):
    golden, ours, _ = case
    got = np.asarray(ours.sigma).reshape(-1)
    np.testing.assert_allclose(got, golden["sigma"], rtol=1e-2, atol=1e-5)


def test_sampling_table_queries(case):
    golden, ours, _ = case
    q = golden["queries"]  # columns: pdf1 cdf1 qf1 pdf2 cdf2 qf2
    NQ = 32
    a = (np.arange(NQ) + 0.5) / NQ
    b = (np.arange(NQ) + 0.5) / NQ
    U, V = np.meshgrid(a, b, indexing="ij")
    u = jnp.asarray(U.ravel(), jnp.float32)
    v = jnp.asarray(V.ravel(), jnp.float32)
    phi = u * 2 * jnp.pi
    theta = v * 0.5 * jnp.pi * 0.98
    np.testing.assert_allclose(np.asarray(ours.pdf1_eval(phi)), q[:, 0],
                               rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ours.cdf1_eval(phi)), q[:, 1],
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours.qf1_eval(u)), q[:, 2],
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ours.pdf2_eval(theta, phi)), q[:, 3],
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ours.cdf2_eval(theta, phi)), q[:, 4],
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ours.qf2_eval(v, phi)), q[:, 5],
                               rtol=2e-2, atol=2e-3)


def test_evalp_through_tabulated(case):
    # the oracle's tabular ctor installs the extracted spline Fresnel
    golden, ours, fres = case
    i, o = orc.evalp_grid_pairs()
    got = np.asarray(mf.evalp(ours, fres,
                              MicrofacetParams.standard(),
                              jnp.asarray(i), jnp.asarray(o)))
    want = golden["evalp_grid"]
    # at the phi=0 azimuth seam a +-1ulp h.y flips atan2 between 0 and
    # 2pi, and the reference's repeat-wrap lookup is discontinuous
    # there (u=1 reads the last azimuth row, not row 0) — a handful of
    # symmetric grid pairs land on opposite sides of that seam, so
    # assert distribution-level agreement instead of pointwise
    rel = np.abs(got - want) / (np.abs(want) + 1e-5)
    assert (rel < 2e-2).mean() > 0.99, f"frac bad {(rel >= 2e-2).mean()}"
    assert np.median(rel) < 1e-3


def test_aniso_fits(case):
    golden, ours, _ = case
    pb = moments.fit_beckmann_parameters_anisotropic(ours)
    got_b = [float(pb.ax), float(pb.ay), float(pb.rho),
             float(pb.txn), float(pb.tyn)]
    np.testing.assert_allclose(got_b, golden["fit_beckmann"], rtol=1e-2,
                               atol=1e-3)
    pg = moments.fit_ggx_parameters_anisotropic(ours)
    got_g = [float(pg.ax), float(pg.ay), float(pg.rho),
             float(pg.txn), float(pg.tyn)]
    np.testing.assert_allclose(got_g, golden["fit_ggx"], rtol=1e-2, atol=1e-3)


def test_midres_45x45_parity():
    """Production-scale sanity at an intermediate resolution the C++
    oracle still finishes quickly (the 16x16 grid alone
    under-exercises the pipeline; the real workload is 90x90,
    dj_brdf.h:2525-2579). Full-table p22/sigma parity + moment fits at
    45x45."""
    a1, a2, phi_a = 0.4, 0.15, 0.35
    golden = orc.run_sections("tabular_aniso", "ggx", a1, a2, phi_a, 45, 45)
    eval_fn = tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(a1, a2, phi_a))
    ours, _ = tabular_aniso.build_tabular_anisotropic(eval_fn, 45, 45)

    np.testing.assert_allclose(np.asarray(ours.p22).reshape(-1),
                               golden["p22"], rtol=1e-2, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ours.sigma).reshape(-1),
                               golden["sigma"], rtol=1e-2, atol=1e-5)

    pb = moments.fit_beckmann_parameters_anisotropic(ours)
    got_b = [float(pb.ax), float(pb.ay), float(pb.rho),
             float(pb.txn), float(pb.tyn)]
    np.testing.assert_allclose(got_b, golden["fit_beckmann"], rtol=1e-2,
                               atol=1e-3)
    pg = moments.fit_ggx_parameters_anisotropic(ours)
    got_g = [float(pg.ax), float(pg.ay), float(pg.rho),
             float(pg.txn), float(pg.tyn)]
    np.testing.assert_allclose(got_g, golden["fit_ggx"], rtol=1e-2, atol=1e-3)
