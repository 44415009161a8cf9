"""Randomized oracle parity sweep: seeded random microfacet parameter
sets across the full elliptic + mean-normal-offset space, checked
against the compiled C++ reference for both evalp and the VNDF
sampler (dj_brdf.h:1529-1547, 1669-1765). Complements the fixed CASES
of test_oracle_microfacet.py with broad-coverage fuzzing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.oracle as orc
from dj_brdf_tpu import fresnel
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
from dj_brdf_tpu.microfacet.params import MicrofacetParams

pytestmark = pytest.mark.skipif(not orc.available(), reason="no C++ oracle")

DIST = {"ggx": GGX(), "beckmann": Beckmann()}


def _random_cases(n_per_dist: int = 8, seed: int = 20260821):
    rng = np.random.default_rng(seed)
    cases = []
    for name in ("ggx", "beckmann"):
        for _ in range(n_per_dist):
            a1 = float(rng.uniform(0.05, 1.2))
            a2 = float(rng.uniform(0.05, 1.2))
            phi_a = float(rng.uniform(0.0, np.pi))
            txn = float(rng.uniform(-0.5, 0.5))
            tyn = float(rng.uniform(-0.5, 0.5))
            cases.append((name, round(a1, 4), round(a2, 4), round(phi_a, 4),
                          round(txn, 4), round(tyn, 4)))
    return cases


CASES = _random_cases()


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_fuzz_evalp_matches_oracle(case):
    name, a1, a2, phi_a, txn, tyn = case
    golden = orc.run_floats("evalp", name, a1, a2, phi_a, txn, tyn)
    i, o = orc.evalp_grid_pairs()
    params = MicrofacetParams.elliptic(a1, a2, phi_a, txn=txn, tyn=tyn)
    got = np.asarray(mf.evalp(DIST[name], fresnel.Ideal(), params,
                              jnp.asarray(i), jnp.asarray(o)))
    np.testing.assert_allclose(got, golden, rtol=5e-4, atol=2e-5)


def _boundary_lanes(params, u1, u2, o):
    """Lanes in the known solver-sensitivity region: extreme sampler
    inputs or a near-grazing *warped* receiver (where the visible-slope
    CDF is flat and any solver may stop at a different iterate within
    the same |CDF-u| tolerance)."""
    ax, ay, rho = (np.float64(params.ax), np.float64(params.ay),
                   np.float64(params.rho))
    txn, tyn = np.float64(params.txn), np.float64(params.tyn)
    s = np.sqrt(max(1.0 - rho * rho, 0.0))
    a = o[:, 0] * ax + o[:, 1] * ay * rho
    b = o[:, 1] * ay * s
    c = o[:, 2] - o[:, 0] * txn - o[:, 1] * tyn
    kz = c / np.sqrt(a * a + b * b + c * c)
    return ((u1 < 0.02) | (u1 > 0.98) | (u2 < 0.02) | (u2 > 0.98)
            | (kz < 0.20))


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_fuzz_sample_matches_oracle(case):
    name, a1, a2, phi_a, txn, tyn = case
    golden = orc.run_floats("sample", name, a1, a2, phi_a, txn, tyn)
    u1, u2, o = orc.sample_grid()
    params = MicrofacetParams.elliptic(a1, a2, phi_a, txn=txn, tyn=tyn)
    i = np.asarray(mf.sample(DIST[name], params, jnp.asarray(u1),
                             jnp.asarray(u2), jnp.asarray(o)))
    pdf = np.asarray(mf.pdf(DIST[name], params, jnp.asarray(i),
                            jnp.asarray(o)))
    # sampled directions: the Beckmann solver may stop at a different
    # iterate for a handful of boundary lanes; distribution-level
    i_close = np.isclose(i, golden[:, :3], rtol=2e-3, atol=5e-4)
    assert i_close.mean() > 0.995, 1 - i_close.mean()
    p_close = np.isclose(pdf, golden[:, 3], rtol=5e-3, atol=5e-4)
    assert p_close.mean() > 0.995, 1 - p_close.mean()
    # ...and the disagreeing lanes must CLUSTER at the known boundary
    # (u near 0/1 or warped theta_k near pi/2) — a scattered interior
    # regression of the same magnitude fails here
    bad = ~(i_close.all(axis=-1) & p_close)
    if bad.any():
        interior_bad = bad & ~_boundary_lanes(
            params, np.asarray(u1), np.asarray(u2), np.asarray(o))
        assert interior_bad.mean() < 5e-4, (
            f"{interior_bad.sum()} disagreeing lanes outside the "
            f"boundary region (of {bad.sum()} total)")


def _fuzz_inputs(seed, n=16384):
    rng = np.random.default_rng(seed)
    from dj_brdf_tpu.core.math import from_spherical
    o = from_spherical(jnp.asarray(rng.uniform(0.02, 1.53, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 2 * np.pi, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    f0 = jnp.asarray(rng.uniform(0.05, 0.95, 3), jnp.float32)
    return u1, u2, o, f0


def _assert_dist_close(got, want, frac=0.9995, cap=5e-3):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        close = np.isclose(g, w, rtol=5e-4, atol=1e-4)
        assert close.mean() > frac, (k, 1 - close.mean())
        assert np.abs(g - w).max() < cap, (k, np.abs(g - w).max())


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_fuzz_fused_soa_kernels_match_layered(case):
    """The production SoA kernels (ops/soa.py) at every seeded
    parameter set: ggx_evalp_is_soa (both samplers) /
    beckmann_evalp_is_soa against the layered mf.evalp_is (itself
    oracle-parity-covered above), the dual-family kernel against the
    per-lane select of the single-family kernels, and (GGX cases)
    ggx_lsq_fwdbwd_soa against XLA autodiff of the SoA loss."""
    from dj_brdf_tpu.microfacet.ndf import GGXSphericalCaps
    from dj_brdf_tpu.ops import soa

    name, a1, a2, phi_a, txn, tyn = case
    params = MicrofacetParams.elliptic(a1, a2, phi_a, txn=txn, tyn=tyn)
    import zlib
    case_seed = zlib.crc32(repr(case).encode())  # deterministic (hash()
    #                                              is salted per process)
    u1, u2, o, f0 = _fuzz_inputs(case_seed & 0x7FFFFFFF)
    fres = fresnel.Schlick(f0=f0)
    pvec = jnp.concatenate([jnp.stack([params.ax, params.ay, params.rho,
                                       params.txn, params.tyn]), f0]
                           ).astype(jnp.float32)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]

    if name == "ggx":
        for caps, dist in ((True, GGXSphericalCaps()), (False, GGX())):
            want = mf.evalp_is(dist, fres, params, u1, u2, o)
            w3, i3, pdf = want
            got = soa.ggx_evalp_is_soa(pvec, u1, u2, ox, oy, oz, caps=caps)
            _assert_dist_close(
                got, (w3[..., 0], w3[..., 1], w3[..., 2],
                      i3[..., 0], i3[..., 1], i3[..., 2], pdf))
        # hand adjoint vs autodiff at this parameter point
        i_d = o[::-1]  # reuse as incident set (any unit batch works)
        comp = soa.split_dirs(i_d, o)
        tr, tg, tb = soa.ggx_evalp_soa(
            jnp.asarray([0.3, 0.3, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                        jnp.float32), *comp)
        want_val, want_grad = jax.value_and_grad(soa.ggx_lsq_loss_soa)(
            pvec, *comp, tr, tg, tb)
        loss_sum, grad_sum = soa.ggx_lsq_fwdbwd_soa(pvec, *comp, tr, tg, tb)
        n = comp[0].size
        np.testing.assert_allclose(float(loss_sum) / n, float(want_val),
                                   rtol=5e-5)
        np.testing.assert_allclose(np.asarray(grad_sum) / n,
                                   np.asarray(want_grad),
                                   rtol=5e-4, atol=1e-6)
    else:
        want = mf.evalp_is(Beckmann(), fres, params, u1, u2, o)
        w3, i3, pdf = want
        got = soa.beckmann_evalp_is_soa(pvec, u1, u2, ox, oy, oz)
        _assert_dist_close(
            got, (w3[..., 0], w3[..., 1], w3[..., 2],
                  i3[..., 0], i3[..., 1], i3[..., 2], pdf))

    # dual-family kernel: this case's params on its family's lanes,
    # a fixed other-family material on the rest
    rng = np.random.default_rng(case_seed & 0xFFFF)
    n = u1.shape[0]
    lx = jnp.broadcast_to(jnp.float32(0.26), (n,))
    ly = jnp.broadcast_to(jnp.float32(0.33), (n,))
    lz = jnp.broadcast_to(jnp.float32(0.905), (n,))
    other = jnp.asarray([0.5, 0.4, 0.1, 0.0, 0.0, 0.4, 0.4, 0.4],
                        jnp.float32)
    pv_b, pv_g = (pvec, other) if name == "beckmann" else (other, pvec)
    is_beck = jnp.asarray(rng.uniform(0, 1, n) < 0.5)
    pvN = jnp.where(is_beck[None, :], pv_b[:, None], pv_g[:, None])
    got = soa.mixed_nee_evalp_is_soa(pvN, is_beck, lx, ly, lz, u1, u2,
                                     ox, oy, oz, caps=False)
    fb3 = soa.beckmann_evalp_soa(pv_b, lx, ly, lz, ox, oy, oz)
    ob = soa.beckmann_evalp_is_soa(pv_b, u1, u2, ox, oy, oz)
    fg3 = soa.ggx_evalp_soa(pv_g, lx, ly, lz, ox, oy, oz)
    og = soa.ggx_evalp_is_soa(pv_g, u1, u2, ox, oy, oz, caps=False)
    want = tuple(jnp.where(is_beck, a, b)
                 for a, b in zip(fb3 + ob, fg3 + og))
    _assert_dist_close(got, want)
