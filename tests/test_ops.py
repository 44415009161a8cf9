"""SoA fast path and the fit-loss Pallas kernel: equivalence with the
general microfacet path and with XLA autodiff (the kernel runs in
interpret mode on the CPU; chip_smoke.py runs it compiled on a GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dj_brdf_tpu import fresnel
from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX
from dj_brdf_tpu.microfacet.params import MicrofacetParams
from dj_brdf_tpu.ops import soa
from dj_brdf_tpu.ops.fused_fit import lsq_value_and_grad_batched


def kernel_value_and_grad(pvec, *data, family="ggx", **kw):
    """The Pallas kernel (interpret mode) at M = 1, as means."""
    n = data[0].size
    s, g = lsq_value_and_grad_batched(pvec[None], *data[:6],
                                      *(t[None] for t in data[6:]),
                                      family=family, interpret=True, **kw)
    return s[0] / n, g[0] / n


def make_batch(rng, n):
    i = from_spherical(jnp.asarray(rng.uniform(0.02, 1.55, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    o = from_spherical(jnp.asarray(rng.uniform(0.02, 1.55, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    return i, o


def test_soa_matches_general_path(rng):
    i, o = make_batch(rng, 4096)
    pvec = jnp.asarray([0.45, 0.2, 0.3, 0.1, -0.05, 0.9, 0.6, 0.3],
                       jnp.float32)
    params = MicrofacetParams.pdfparams(*[pvec[k] for k in range(5)])
    fres = fresnel.Schlick(f0=pvec[5:8])
    want = np.asarray(mf.evalp(GGX(), fres, params, i, o))
    r, g, b = soa.ggx_evalp_soa(pvec, *soa.split_dirs(i, o))
    got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_fused_kernel_matches_autodiff(rng):
    n = 128 * 256 * 2
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    pvec_true = jnp.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32)
    tr, tg, tb = soa.ggx_evalp_soa(pvec_true, *comp)

    pvec = jnp.asarray([0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
                       jnp.float32)
    want_val, want_grad = jax.value_and_grad(soa.ggx_lsq_loss_soa)(
        pvec, *comp, tr, tg, tb)
    for block in (256, 1024):
        got_val, got_grad = kernel_value_and_grad(pvec, *comp, tr, tg, tb,
                                                  block=block)
        np.testing.assert_allclose(float(got_val), float(want_val),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got_grad),
                                   np.asarray(want_grad),
                                   rtol=3e-4, atol=1e-6)


def test_hand_adjoint_matches_autodiff(rng):
    """soa.ggx_lsq_fwdbwd_soa (analytic adjoint) == jax.grad of the
    loss, including at gated/degenerate samples."""
    n = 8192
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    pvec_true = jnp.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32)
    tr, tg, tb = soa.ggx_evalp_soa(pvec_true, *comp)
    for pv in ([0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
               [0.05, 0.8, -0.7, 0.3, -0.2, 0.99, 0.01, 0.5]):
        pvec = jnp.asarray(pv, jnp.float32)
        want_val, want_grad = jax.value_and_grad(soa.ggx_lsq_loss_soa)(
            pvec, *comp, tr, tg, tb)
        loss_sum, grad_sum = soa.ggx_lsq_fwdbwd_soa(pvec, *comp, tr, tg, tb)
        np.testing.assert_allclose(float(loss_sum) / n, float(want_val),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(grad_sum) / n,
                                   np.asarray(want_grad),
                                   rtol=2e-4, atol=1e-7)

    # degenerate: o below horizon and i == -o must contribute exactly 0
    pvec = jnp.asarray([0.4, 0.3, 0.1, 0.0, 0.0, 0.5, 0.5, 0.5], jnp.float32)
    bad_o = jnp.stack([jnp.zeros(4), jnp.zeros(4), -jnp.ones(4)], -1)
    bi = soa.split_dirs(i[:4], bad_o)
    z = jnp.zeros(4)
    ls, gr = soa.ggx_lsq_fwdbwd_soa(pvec, *bi, z, z, z)
    assert float(ls) == 0.0
    assert np.isfinite(np.asarray(gr)).all()
    np.testing.assert_array_equal(np.asarray(gr), np.zeros(8))


def test_fused_kernel_padding(rng):
    """A sample count that is no multiple of the block: the masked
    tail lanes contribute nothing."""
    n = 1000  # not a multiple of the 256-sample block
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    pvec_true = jnp.asarray([0.3, 0.3, 0.0, 0.0, 0.0, 0.8, 0.8, 0.8],
                            jnp.float32)
    tr, tg, tb = soa.ggx_evalp_soa(pvec_true, *comp)
    pvec = jnp.asarray([0.5, 0.4, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5], jnp.float32)

    got_val, got_grad = kernel_value_and_grad(pvec, *comp, tr, tg, tb)
    want_val, want_grad = jax.value_and_grad(soa.ggx_lsq_loss_soa)(
        pvec, *comp, tr, tg, tb)
    np.testing.assert_allclose(float(got_val), float(want_val), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_grad), np.asarray(want_grad),
                               rtol=3e-4, atol=5e-6)


def test_fused_evalp_is_matches_layered(rng):
    """ops/soa.py::ggx_evalp_is_soa (fused sample+eval) == the layered
    mf.evalp_is for both the spherical-caps and reference-qf samplers
    (reference microfacet::evalp_is, dj_brdf.h:1734-1765)."""
    from dj_brdf_tpu.microfacet.ndf import GGXSphericalCaps

    n = 65536
    o = from_spherical(jnp.asarray(rng.uniform(0.02, 1.5, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 2 * np.pi, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    pvec = jnp.asarray([0.45, 0.2, 0.3, 0.05, -0.04, 0.9, 0.6, 0.3],
                       jnp.float32)
    params = MicrofacetParams.pdfparams(*[pvec[k] for k in range(5)])
    fres = fresnel.Schlick(f0=pvec[5:8])

    for caps, dist in ((True, GGXSphericalCaps()), (False, GGX())):
        want_w, want_i, want_p = mf.evalp_is(dist, fres, params, u1, u2, o)
        wr, wg, wb, ix, iy, iz, pdf = soa.ggx_evalp_is_soa(
            pvec, u1, u2, o[..., 0], o[..., 1], o[..., 2], caps=caps)
        got_i = np.stack([np.asarray(ix), np.asarray(iy), np.asarray(iz)], -1)
        got_w = np.stack([np.asarray(wr), np.asarray(wg), np.asarray(wb)], -1)
        np.testing.assert_allclose(got_i, np.asarray(want_i),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got_w, np.asarray(want_w),
                                   rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(np.asarray(pdf), np.asarray(want_p),
                                   rtol=5e-4, atol=1e-4)
        assert float((np.asarray(pdf) > 0).mean()) > 0.85


def test_fused_beckmann_evalp_is_matches_layered(rng):
    """ops/soa.py::beckmann_evalp_is_soa == layered mf.evalp_is with
    the Halley qf2 solve (dj_brdf.h:1897-1952). A handful of samples
    sit exactly on the convergence boundary where a 1-ulp input
    difference (rsqrt vs sqrt normalize) changes the iteration path,
    so assert distribution-level agreement: >99.99% of lanes pointwise
    close, the rest bounded."""
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    n = 65536
    o = from_spherical(jnp.asarray(rng.uniform(0.02, 1.5, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 2 * np.pi, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    pvec = jnp.asarray([0.45, 0.2, 0.3, 0.05, -0.04, 0.9, 0.6, 0.3],
                       jnp.float32)
    params = MicrofacetParams.pdfparams(*[pvec[k] for k in range(5)])
    fres = fresnel.Schlick(f0=pvec[5:8])

    want_w, want_i, want_p = mf.evalp_is(Beckmann(), fres, params, u1, u2, o)
    wr, wg, wb, ix, iy, iz, pdf = soa.beckmann_evalp_is_soa(
        pvec, u1, u2, o[..., 0], o[..., 1], o[..., 2])
    got_i = np.stack([np.asarray(ix), np.asarray(iy), np.asarray(iz)], -1)
    got_w = np.stack([np.asarray(wr), np.asarray(wg), np.asarray(wb)], -1)

    for got, want, atol in ((got_i, np.asarray(want_i), 2e-5),
                            (got_w, np.asarray(want_w), 5e-5),
                            (np.asarray(pdf), np.asarray(want_p), 1e-4)):
        close = np.isclose(got, want, rtol=5e-4, atol=atol)
        assert close.mean() > 0.9999, f"frac bad {1 - close.mean()}"
        assert np.abs(got - want).max() < 5e-3
    assert float((np.asarray(pdf) > 0).mean()) > 0.85


def test_batched_fused_kernel_matches_vmapped_adjoint(rng):
    """lsq_value_and_grad_batched (shared-direction material batch, the
    material loop inside each block) == vmap of the hand adjoint."""
    m, n = 3, 128 * 256 + 77
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    pvec_true = jnp.asarray([0.25, 0.3, 0.1, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32)
    tr, tg, tb = soa.ggx_evalp_soa(pvec_true, *comp)
    # per-material targets: scaled copies
    scale = jnp.asarray([1.0, 0.5, 2.0], jnp.float32)[:, None]
    trm, tgm, tbm = tr * scale, tg * scale, tb * scale

    pvecs = jnp.asarray([[0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
                         [0.2, 0.6, -0.2, 0.0, 0.1, 0.8, 0.2, 0.4],
                         [0.35, 0.35, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5]],
                        jnp.float32)

    got_sums, got_gsums = lsq_value_and_grad_batched(
        pvecs, *comp, trm, tgm, tbm, interpret=True)

    want_sums, want_gsums = jax.vmap(
        lambda pv, a, b, c: soa.ggx_lsq_fwdbwd_soa(pv, *comp, a, b, c))(
            pvecs, trm, tgm, tbm)
    np.testing.assert_allclose(np.asarray(got_sums) / n,
                               np.asarray(want_sums) / n, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_gsums) / n,
                               np.asarray(want_gsums) / n,
                               rtol=3e-4, atol=1e-6)


def test_fit_lsq_fused_matches_layered(rng):
    """fit_lsq's fused dispatch (the product path) converges to the
    same parameters as the layered autodiff path."""
    from dj_brdf_tpu.core.math import from_spherical
    from dj_brdf_tpu.fit import lsq

    n = 4096
    i, o = make_batch(rng, n)
    true_params = MicrofacetParams.elliptic(0.3, 0.15, 0.4)
    true_f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    target = mf.evalp(GGX(), fresnel.Schlick(f0=true_f0), true_params, i, o)

    p_f, f_f, l_f = lsq.fit_lsq(GGX(), i, o, target, steps=150)
    p_l, f_l, l_l = lsq.fit_lsq(GGX(), i, o, target, steps=150,
                                fused="never")
    # same adjoint math to f32 rounding: trajectories track closely
    np.testing.assert_allclose(np.asarray(l_f), np.asarray(l_l),
                               rtol=1e-2, atol=1e-5)
    for a, b in ((p_f.ax, p_l.ax), (p_f.ay, p_l.ay), (p_f.rho, p_l.rho)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(f_f.f0), np.asarray(f_l.f0),
                               atol=5e-3)


def test_fit_materials_fused_matches_layered(rng):
    """fit/batch.py::fit_materials fused dispatch == layered path."""
    from dj_brdf_tpu.fit.batch import fit_materials

    m, n = 3, 2048
    i, o = make_batch(rng, n)
    alphas = [0.15, 0.3, 0.6]
    targets = jnp.stack([
        mf.evalp(GGX(), fresnel.Schlick(
            f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
            MicrofacetParams.isotropic(a), i, o)
        for a in alphas])

    pf, ff, lf = fit_materials(targets, i, o, steps=120)
    pl, fl, ll = fit_materials(targets, i, o, steps=120, fused="never")
    np.testing.assert_allclose(np.asarray(lf), np.asarray(ll),
                               rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(pf.ax), np.asarray(pl.ax),
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ff.f0), np.asarray(fl.f0),
                               atol=5e-3)
    # and both recover the truth
    np.testing.assert_allclose(np.asarray(pf.ax), alphas, rtol=0.1)


def test_beckmann_evalp_soa_matches_general_path(rng):
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    i, o = make_batch(rng, 4096)
    pvec = jnp.asarray([0.45, 0.2, 0.3, 0.1, -0.05, 0.9, 0.6, 0.3],
                       jnp.float32)
    params = MicrofacetParams.pdfparams(*[pvec[k] for k in range(5)])
    fres = fresnel.Schlick(f0=pvec[5:8])
    want = np.asarray(mf.evalp(Beckmann(), fres, params, i, o))
    r, g, b = soa.beckmann_evalp_soa(pvec, *soa.split_dirs(i, o))
    got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=1e-5)

    # per-sample (8, N) parameter rows broadcast identically
    pvN = jnp.broadcast_to(pvec[:, None], (8, i.shape[0]))
    rN, gN, bN = soa.beckmann_evalp_soa(pvN, *soa.split_dirs(i, o))
    np.testing.assert_allclose(np.asarray(rN), np.asarray(r), rtol=1e-6)


def test_ggx_evalp_is_soa_per_sample_pvec(rng):
    """(8, N) pvec rows (per-ray material parameters — the path
    tracer's same-family select) == scalar pvec per slice."""
    n = 512
    o = from_spherical(jnp.asarray(rng.uniform(0.1, 1.4, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    pv0 = jnp.asarray([0.3, 0.15, 0.2, 0.0, 0.0, 0.9, 0.6, 0.3], jnp.float32)
    pv1 = jnp.asarray([0.6, 0.6, 0.0, 0.0, 0.0, 0.3, 0.3, 0.3], jnp.float32)
    sel = jnp.asarray(rng.uniform(0, 1, n) < 0.5)
    pvN = jnp.where(sel[None, :], pv0[:, None], pv1[:, None])
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    got = soa.ggx_evalp_is_soa(pvN, u1, u2, ox, oy, oz)
    want0 = soa.ggx_evalp_is_soa(pv0, u1, u2, ox, oy, oz)
    want1 = soa.ggx_evalp_is_soa(pv1, u1, u2, ox, oy, oz)
    for gN, w0, w1 in zip(got, want0, want1):
        np.testing.assert_allclose(np.asarray(gN),
                                   np.where(np.asarray(sel), np.asarray(w0),
                                            np.asarray(w1)), rtol=1e-6)


def test_mixed_dual_kernel_matches_single_family(rng):
    """soa.mixed_nee_evalp_is_soa == per-lane select of the two
    single-family kernels (NEE evalp + evalp_is + pdf), for GGX
    lanes via the reference-qf sampler."""
    n = 8192
    o = from_spherical(jnp.asarray(rng.uniform(0.05, 1.5, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    l = from_spherical(jnp.asarray(rng.uniform(0.05, 1.5, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    pv0 = jnp.asarray([0.3, 0.15, 0.2, 0.02, -0.04, 0.9, 0.6, 0.3],
                      jnp.float32)
    pv1 = jnp.asarray([0.6, 0.5, 0.0, 0.0, 0.0, 0.3, 0.3, 0.3], jnp.float32)
    is_beck = jnp.asarray(rng.uniform(0, 1, n) < 0.5)
    pv = jnp.where(is_beck[None, :], pv0[:, None], pv1[:, None])

    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]

    fb3 = soa.beckmann_evalp_soa(pv0, lx, ly, lz, ox, oy, oz)
    ob = soa.beckmann_evalp_is_soa(pv0, u1, u2, ox, oy, oz)
    fg3 = soa.ggx_evalp_soa(pv1, lx, ly, lz, ox, oy, oz)
    for caps in (False, True):
        got = soa.mixed_nee_evalp_is_soa(pv, is_beck, lx, ly, lz, u1, u2,
                                         ox, oy, oz, caps=caps)
        og = soa.ggx_evalp_is_soa(pv1, u1, u2, ox, oy, oz, caps=caps)
        want = tuple(jnp.where(is_beck, a, b)
                     for a, b in zip(fb3 + ob, fg3 + og))
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = np.asarray(g), np.asarray(w)
            close = np.isclose(g, w, rtol=5e-4, atol=5e-5)
            assert close.mean() > 0.9995, (caps, k, 1 - close.mean())
            assert np.abs(g - w).max() < 5e-3, (caps, k)


def test_fused_weights_energy_bound(rng):
    """Physics invariant on every fused sampler: for CENTERED
    distributions (zero mean-normal offset — with offsets sigma(k) can
    drop below k.z and G1 legitimately exceeds 1, in the reference
    too) the IS weight F*G/G1(o) lies in [0, 1] per channel when
    F <= 1 (G <= G1o, dj_brdf.h:1644-1665), for uniform and per-ray
    parameter rows, across all four kernels."""
    n = 1 << 15
    o = from_spherical(jnp.asarray(rng.uniform(0.02, 1.55, n), jnp.float32),
                       jnp.asarray(rng.uniform(0, 6.28, n), jnp.float32))
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    pv0 = jnp.asarray([0.8, 0.05, 0.6, 0.0, 0.0, 1.0, 1.0, 1.0], jnp.float32)
    pv1 = jnp.asarray([0.02, 0.9, -0.8, 0.0, 0.0, 1.0, 1.0, 1.0], jnp.float32)
    sel = jnp.asarray(rng.uniform(0, 1, n) < 0.5)
    pvN = jnp.where(sel[None, :], pv0[:, None], pv1[:, None])

    outs = [
        soa.ggx_evalp_is_soa(pvN, u1, u2, ox, oy, oz, caps=True),
        soa.ggx_evalp_is_soa(pvN, u1, u2, ox, oy, oz, caps=False),
        soa.beckmann_evalp_is_soa(pvN, u1, u2, ox, oy, oz),
        soa.mixed_nee_evalp_is_soa(pvN, sel, ox, oy, oz, u1, u2,
                                   ox, oy, oz)[3:],
    ]
    for out in outs:
        wr, wg, wb, ix, iy, iz, pdf = out
        for w in (wr, wg, wb):
            w = np.asarray(w)
            assert np.isfinite(w).all()
            assert w.min() >= 0.0
            assert w.max() <= 1.0 + 1e-4
        assert np.isfinite(np.asarray(pdf)).all()
        assert float(np.asarray(pdf).min()) >= 0.0
        # sampled directions are unit where pdf > 0
        m = np.asarray(pdf) > 0
        nrm = np.asarray(ix * ix + iy * iy + iz * iz)[m]
        np.testing.assert_allclose(nrm, 1.0, atol=1e-3)


def test_fit_lsq_sharded_matches_unsharded(rng):
    """fit_lsq with a data-axis sharding (fused XLA-adjoint path,
    gradient psum inserted by pjit) == the unsharded fit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.parallel.mesh import DATA_AXIS, make_mesh

    n = 2048
    i, o = make_batch(rng, n)
    target = mf.evalp(
        GGX(), fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.isotropic(0.3), i, o)

    p0, f0, l0 = lsq.fit_lsq(GGX(), i, o, target, steps=80)
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P(DATA_AXIS))
    p1, f1, l1 = lsq.fit_lsq(GGX(), i, o, target, steps=80, in_shardings=sh)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l0),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(p1.ax), float(p0.ax), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(f1.f0), np.asarray(f0.f0),
                               atol=1e-3)


def test_make_fused_value_and_grad_pallas_interpret(rng, monkeypatch):
    """fit.lsq.make_fused_value_and_grad's kernel route (what an
    unsharded GPU fit runs), in interpret mode, == the XLA-adjoint
    route, at an odd sample count (exercises the masked tail)."""
    import functools

    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.ops import fused_fit

    monkeypatch.setattr(fused_fit, "lsq_value_and_grad_batched",
                        functools.partial(lsq_value_and_grad_batched,
                                          interpret=True))
    n = 5000  # not a multiple of the 256-sample block
    i, o = make_batch(rng, n)
    target = mf.evalp(
        GGX(), fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.isotropic(0.3), i, o)
    raw = lsq.raw_init()

    vg_p, data_p = lsq.make_fused_value_and_grad(i, o, target,
                                                 route="kernel")
    vg_x, data_x = lsq.make_fused_value_and_grad(i, o, target,
                                                 route="xla")
    val_p, g_p = vg_p(raw, *data_p)
    val_x, g_x = vg_x(raw, *data_x)
    np.testing.assert_allclose(float(val_p), float(val_x), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(g_p),
                    jax.tree_util.tree_leaves(g_x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)


def test_beckmann_hand_adjoint_matches_autodiff(rng):
    """soa.beckmann_lsq_fwdbwd_soa == jax.grad of the Beckmann loss at
    randomized parameter sets (the fuzz-seed style sweep), including
    gated/degenerate samples."""
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    n = 8192
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    for seed in range(8):
        r = np.random.default_rng(seed + 41)
        pv_true = jnp.asarray(
            [r.uniform(0.1, 0.6), r.uniform(0.1, 0.6),
             r.uniform(-0.5, 0.5), r.uniform(-0.2, 0.2),
             r.uniform(-0.2, 0.2), r.uniform(0.2, 0.95),
             r.uniform(0.2, 0.95), r.uniform(0.2, 0.95)], jnp.float32)
        tr, tg, tb = soa.beckmann_evalp_soa(pv_true, *comp)
        pvec = jnp.asarray(
            [r.uniform(0.15, 0.5), r.uniform(0.15, 0.5),
             r.uniform(-0.4, 0.4), r.uniform(-0.1, 0.1),
             r.uniform(-0.1, 0.1), 0.5, 0.5, 0.5], jnp.float32)
        want_val, want_grad = jax.value_and_grad(
            soa.beckmann_lsq_loss_soa)(pvec, *comp, tr, tg, tb)
        loss_sum, grad_sum = soa.beckmann_lsq_fwdbwd_soa(
            pvec, *comp, tr, tg, tb)
        np.testing.assert_allclose(float(loss_sum) / n, float(want_val),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(grad_sum) / n,
                                   np.asarray(want_grad),
                                   rtol=3e-3, atol=2e-6)

    # degenerate: o below horizon contributes exactly 0
    pvec = jnp.asarray([0.4, 0.3, 0.1, 0.0, 0.0, 0.5, 0.5, 0.5],
                       jnp.float32)
    bad_o = jnp.stack([jnp.zeros(4), jnp.zeros(4), -jnp.ones(4)], -1)
    bi = soa.split_dirs(i[:4], bad_o)
    z = jnp.zeros(4)
    ls, gr = soa.beckmann_lsq_fwdbwd_soa(pvec, *bi, z, z, z)
    assert float(ls) == 0.0
    assert np.isfinite(np.asarray(gr)).all()
    np.testing.assert_array_equal(np.asarray(gr), np.zeros(8))


def test_beckmann_fused_kernel_matches_autodiff(rng):
    """The Pallas kernel with family="beck" (interpret mode) == XLA
    autodiff of the Beckmann loss."""
    n = 128 * 256 + 5
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    pvec_true = jnp.asarray([0.3, 0.2, 0.2, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32)
    tr, tg, tb = soa.beckmann_evalp_soa(pvec_true, *comp)
    pvec = jnp.asarray([0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
                       jnp.float32)
    want_val, want_grad = jax.value_and_grad(soa.beckmann_lsq_loss_soa)(
        pvec, *comp, tr, tg, tb)
    got_val, got_grad = kernel_value_and_grad(pvec, *comp, tr, tg, tb,
                                              family="beck")
    np.testing.assert_allclose(float(got_val), float(want_val), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_grad),
                               np.asarray(want_grad),
                               rtol=3e-3, atol=2e-6)


def test_fit_lsq_beckmann_fused_matches_layered(rng):
    """fit_lsq routes Beckmann through the hand adjoint (fused="auto")
    and tracks the layered path (the reference treats the Beckmann fit
    as co-equal with GGX, dj_brdf.h:3133-3158)."""
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    n = 4096
    i, o = make_batch(rng, n)
    true_params = MicrofacetParams.elliptic(0.3, 0.15, 0.4)
    true_f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    target = mf.evalp(Beckmann(), fresnel.Schlick(f0=true_f0),
                      true_params, i, o)

    assert lsq.fused_eligible(Beckmann()) == "beck"
    p_f, f_f, l_f = lsq.fit_lsq(Beckmann(), i, o, target, steps=150)
    p_l, f_l, l_l = lsq.fit_lsq(Beckmann(), i, o, target, steps=150,
                                fused="never")
    np.testing.assert_allclose(np.asarray(l_f), np.asarray(l_l),
                               rtol=1e-2, atol=1e-5)
    for a, b in ((p_f.ax, p_l.ax), (p_f.ay, p_l.ay), (p_f.rho, p_l.rho)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2,
                                   atol=1e-3)
    np.testing.assert_allclose(np.asarray(f_f.f0), np.asarray(f_l.f0),
                               atol=5e-3)


def test_fit_materials_beckmann_fused(rng):
    """Batched Beckmann fits go through the family-routed adjoint and
    recover the truth."""
    from dj_brdf_tpu.fit.batch import fit_materials
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    n = 2048
    i, o = make_batch(rng, n)
    alphas = [0.2, 0.45]
    targets = jnp.stack([
        mf.evalp(Beckmann(), fresnel.Schlick(
            f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
            MicrofacetParams.isotropic(a), i, o)
        for a in alphas])
    pf, ff, lf = fit_materials(targets, i, o, steps=150,
                               dist=Beckmann())
    np.testing.assert_allclose(np.asarray(pf.ax), alphas, rtol=0.1)
    assert np.isfinite(np.asarray(lf)).all()


def test_normal_incidence_sampling_not_collapsed(rng):
    """Regression (round-5 review): the floored sin under the sqrt
    means exact normal incidence reads sin_k = 1e-12, never 0 — an
    `== 0` normal-incidence test goes dead and zeroes the azimuthal
    rotation frame, collapsing every VNDF sample to the mean normal.
    At o = +z the sampled directions must still spread."""
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    n = 64
    pv = jnp.asarray([0.5, 0.5, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                     jnp.float32)
    z = jnp.zeros(n)
    o1 = jnp.ones(n)
    u1 = jnp.asarray(rng.uniform(0.05, 0.95, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0.05, 0.95, n), jnp.float32)
    for kernel in (lambda: soa.ggx_evalp_is_soa(pv, u1, u2, z, z, o1,
                                                caps=False),
                   lambda: soa.beckmann_evalp_is_soa(pv, u1, u2, z, z,
                                                     o1),
                   lambda: soa.mixed_nee_evalp_is_soa(
                       pv, jnp.arange(n) % 2 == 0, z, z, o1, u1, u2,
                       z, z, o1)[-7:]):
        out = kernel()
        ixy = np.stack([np.asarray(out[3]), np.asarray(out[4])], -1)
        assert np.abs(ixy).max() > 0.05, "samples collapsed to +z"
        assert np.unique(np.round(ixy, 4), axis=0).shape[0] > n // 2
    # layered path too
    o3 = jnp.stack([z, z, o1], -1)
    i_l = mf.sample(Beckmann(), MicrofacetParams.isotropic(0.5), u1, u2,
                    o3)
    assert float(np.abs(np.asarray(i_l)[:, :2]).max()) > 0.05


@pytest.mark.parametrize("family", ["ggx", "beck"])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_xla_adjoint_matches_autodiff_odd_sizes(rng, family, n):
    """The plain-XLA hand adjoint (the route of sharded and non-GPU
    fits) == autodiff of the loss for both families at odd sizes."""
    fwdbwd = {"ggx": soa.ggx_lsq_fwdbwd_soa,
              "beck": soa.beckmann_lsq_fwdbwd_soa}[family]
    loss = {"ggx": soa.ggx_lsq_loss_soa,
            "beck": soa.beckmann_lsq_loss_soa}[family]
    evalp = {"ggx": soa.ggx_evalp_soa, "beck": soa.beckmann_evalp_soa}[family]
    i, o = make_batch(rng, n)
    comp = soa.split_dirs(i, o)
    tgt = evalp(jnp.asarray([0.3, 0.2, 0.2, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32), *comp)
    pvec = jnp.asarray([0.4, 0.3, 0.1, 0.02, -0.03, 0.5, 0.5, 0.5],
                       jnp.float32)
    want_val, want_grad = jax.value_and_grad(loss)(pvec, *comp, *tgt)
    s, g = fwdbwd(pvec, *comp, *tgt)
    np.testing.assert_allclose(float(s) / n, float(want_val), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(g) / n, np.asarray(want_grad),
                               rtol=3e-3, atol=2e-6)


@pytest.mark.parametrize("family", ["ggx", "beck"])
def test_vmapped_xla_adjoint_matches_batched_autodiff(rng, family):
    """The batched plain-XLA adjoint (fit.batch's "xla" route: vmap
    over materials, shared directions) == vmap of autodiff."""
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.fit.batch import make_batched_value_and_grad
    from dj_brdf_tpu.microfacet.ndf import Beckmann

    dist = GGX() if family == "ggx" else Beckmann()
    m, n = 3, 777
    i, o = make_batch(rng, n)
    targets = jnp.stack([mf.evalp(dist, fresnel.Schlick(
        f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.isotropic(a), i, o) for a in (0.2, 0.35, 0.5)])
    raw = jax.vmap(lambda _: lsq.raw_init())(jnp.arange(m))
    got = {}
    for route in ("xla", "autodiff"):
        vg, data = make_batched_value_and_grad(targets, i, o, dist, route)
        got[route] = vg(raw, *data)
    np.testing.assert_allclose(np.asarray(got["xla"][0]),
                               np.asarray(got["autodiff"][0]), rtol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got["xla"][1]),
                    jax.tree_util.tree_leaves(got["autodiff"][1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-3, atol=2e-6)


def test_batched_kernel_route_matches_xla_route(rng, monkeypatch):
    """fit.batch's "kernel" route (interpret mode) == its "xla" route."""
    import functools

    from dj_brdf_tpu.fit import batch, lsq
    from dj_brdf_tpu.ops import fused_fit

    m, n = 2, 600
    i, o = make_batch(rng, n)
    targets = jnp.stack([mf.evalp(GGX(), fresnel.Schlick(
        f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.isotropic(a), i, o) for a in (0.2, 0.5)])
    raw = jax.vmap(lambda _: lsq.raw_init())(jnp.arange(m))
    monkeypatch.setattr(fused_fit, "lsq_value_and_grad_batched",
                        functools.partial(lsq_value_and_grad_batched,
                                          interpret=True))
    got = {}
    for route in ("kernel", "xla"):
        vg, data = batch.make_batched_value_and_grad(targets, i, o, GGX(),
                                                     route)
        got[route] = vg(raw, *data)
    np.testing.assert_allclose(np.asarray(got["kernel"][0]),
                               np.asarray(got["xla"][0]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got["kernel"][1]),
                    jax.tree_util.tree_leaves(got["xla"][1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-7)


@pytest.mark.parametrize("fused,sharded,platform,want", [
    ("auto", False, "gpu", "kernel"),
    ("auto", True, "gpu", "xla"),
    ("auto", False, "cpu", "xla"),
    ("never", False, "gpu", "autodiff"),
])
def test_adjoint_route(fused, sharded, platform, want):
    """One routing rule: the kernel only on an unsharded GPU fit,
    autodiff when asked for or when no hand adjoint exists."""
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import Beckmann, GGXSphericalCaps

    for dist in (GGX(), Beckmann(), GGXSphericalCaps()):
        assert lsq.adjoint_route(dist, fused=fused, sharded=sharded,
                                 platform=platform) == want
    assert lsq.adjoint_route(GGX(), shadow=False,
                             platform=platform) == "autodiff"
    assert lsq.adjoint_route(GGX()) == "xla"   # this test host: CPU
    with pytest.raises(ValueError, match="fused must be"):
        lsq.adjoint_route(GGX(), fused="always")
