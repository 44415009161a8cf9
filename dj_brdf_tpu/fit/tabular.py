"""Isotropic tabulation pipeline: extract a microfacet NDF + Fresnel
from any BRDF by power iteration.

JAX version of the ``djb::tabular`` constructor pipeline
(dj_brdf.h:2215-2236):

    compute_p22_smith -> normalize_p22 -> compute_sigma ->
    compute_fresnel -> compute_cdf -> compute_qf

The serial scalar loops become batched jnp expressions (the kernel
matrix is built as one outer-product-shaped expression; the sigma
table is one (res x 90 x 180) tensor contraction). The reference's
idiosyncratic quadrature grids, weights, float_t accumulation of the
phi loop, the unnormalized 4-step power iteration, and the 1e-2 scale
are replicated exactly so fitted parameters match the C++ oracle.

BRDF inputs are either *eval functions* ``eval_fn(i, o) -> (..., 3)``
or model pytrees with an ``.eval(i, o)`` method (Merl, Utia, Sgd, ...).
Prefer passing the model object: its tables then enter the jitted
stages as *arguments*; an eval_fn closing over device tables embeds
them as XLA program constants, which inflates compile time by minutes
and hits a pathologically slow gather path (docs/DESIGN.md §6).

Precision follows ``config.default_float()`` (the reference's
DJB_USE_DOUBLE_PRECISION switch, dj_brdf.h:44-48): with
``jax_enable_x64`` on, every quadrature runs in float64 and tables are
float64, enabling ~1e-6 parity against a double-precision oracle.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from dj_brdf_tpu import config
from dj_brdf_tpu import fresnel as fresnel_mod
from dj_brdf_tpu.core import spline
from dj_brdf_tpu.core.math import from_spherical, hd_to_io, intensity, vec3
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import Tabular
from dj_brdf_tpu.microfacet.params import MicrofacetParams


def as_model_eval(brdf):
    """Normalize a BRDF argument to ``(eval(model, i, o), model)``.

    ``brdf`` may be a bare callable (model=None, kept for backward
    compatibility) or a pytree object with ``.eval``; the latter routes
    its tables through jit as arguments instead of closure constants."""
    if callable(brdf) and not hasattr(brdf, "eval"):
        return (lambda _model, i, o: brdf(i, o)), None
    return (lambda model, i, o: model.eval(i, o)), brdf


def _phi_grid(dtype) -> np.ndarray:
    """The reference's inner phi loop accumulates a float_t step
    (dj_brdf.h:2499, 2508): replicate the accumulation in the active
    precision so the step count and node positions match bit-for-bit."""
    ft = np.dtype(dtype).type
    step = ft(np.pi / 180.0)
    two_pi = ft(2.0 * np.pi)
    vals = []
    phi = ft(0.0)
    while phi < two_pi:
        vals.append(phi)
        phi = ft(phi + step)
    return np.asarray(vals, dtype)


def _kernel_matrix(eval_fn, model, res: int, dtype=None) -> jnp.ndarray:
    """The (cnt, cnt) retro-reflective kernel matrix A with
    A[i, j] = K(j, i) so that one power-iteration step is ``A @ v``
    (reference tabular::compute_p22_smith kernel build,
    dj_brdf.h:2482-2515 + the matrix layout of 2442-2465)."""
    ft = dtype or config.default_float()
    cnt = res - 1
    dtheta = np.sqrt(np.pi * 0.5) / cnt

    t = (jnp.arange(cnt, dtype=ft) / cnt) * ft(np.sqrt(np.pi * 0.5))
    theta = t * t  # angles in [0, pi/2)
    cos_theta = jnp.cos(theta)
    tan_theta = jnp.tan(theta)

    # column terms: retro-reflective BRDF slice fr(theta_o, theta_o)
    d = from_spherical(theta, jnp.zeros_like(theta))
    fr_i = intensity(eval_fn(model, d, d).astype(ft))
    kji_tmp = (ft(dtheta) * cos_theta ** 6) * (8.0 * fr_i)  # (cnt,) per col

    # inner phi integral: nint[j, i] = sum_phi max(1, tan_j tan_i cos(phi)) dphi
    phis = jnp.asarray(_phi_grid(ft))
    dphi = ft(np.pi / 180.0)
    tan_prod = tan_theta[:, None] * tan_theta[None, :]  # (j, i)
    nint = jnp.sum(jnp.maximum(1.0, tan_prod[..., None] * jnp.cos(phis)),
                   axis=-1) * dphi

    # K[j, i] = theta_j * kji_tmp_i * nint_ji * tan_j / cos_j^2;
    # matrix::transform computes out[i] = sum_j K(j, i) v[j], so return
    # the transpose A[i, j] = K(j, i)
    K = (t[:, None] * kji_tmp[None, :] * nint
         * (tan_theta / cos_theta ** 2)[:, None])
    return K.T


def _power_iteration(A, iterations: int = 4) -> jnp.ndarray:
    """Unnormalized power iteration from an all-ones start in float64
    (reference matrix::eigenvector, dj_brdf.h:2467-2480 — the matrix
    class is always double regardless of float_t), the 1e-2 scale and
    trailing zero of compute_p22_smith (:2517-2521)."""
    ft = config.default_float()
    A = np.asarray(A, np.float64)
    v = np.ones(A.shape[0], np.float64)
    for _ in range(iterations):
        v = A @ v
    p22 = np.concatenate([1e-2 * v, [0.0]])
    return jnp.asarray(p22, ft)


def compute_p22_smith(brdf, res: int, iterations: int = 4) -> jnp.ndarray:
    """Kernel build + power iteration (reference
    tabular::compute_p22_smith, dj_brdf.h:2482-2522). Returns the
    (res,) unnormalized p22 table."""
    eval_fn, model = as_model_eval(brdf)
    return _power_iteration(_kernel_matrix(eval_fn, model, res), iterations)


def normalize_p22(p22: jnp.ndarray, return_nint: bool = False):
    """128-pt u^2-warped quadrature normalization (reference
    tabular::normalize_p22, dj_brdf.h:2277-2304)."""
    ft = p22.dtype
    ntheta = 128
    dphi = 2.0 * np.pi
    dtheta = np.pi / ntheta
    u = jnp.arange(ntheta, dtype=ft) / ntheta
    theta_h = u * u * ft.type(np.pi * 0.5)
    r_h = jnp.tan(theta_h)
    cos_theta_h = jnp.cos(theta_h)
    # p22_radial spline lookup in the sqrt-atan warp (dj_brdf.h:2151-2156)
    uu = jnp.sqrt(2.0 * jnp.arctan(r_h) / jnp.pi)
    p22_r = spline.eval1d(p22, uu, wrap="edge")
    nint = jnp.sum((u * p22_r * r_h) / (cos_theta_h * cos_theta_h))
    nint = nint * ft.type(dtheta) * ft.type(dphi)
    if return_nint:
        return p22 / nint, nint
    return p22 / nint


def compute_sigma(p22: jnp.ndarray) -> jnp.ndarray:
    """Projected-area table via a (res x 90 x 180) contraction
    (reference tabular::compute_sigma, dj_brdf.h:2348-2386)."""
    ft = p22.dtype
    res = p22.shape[0]
    cnt = res - 1
    ntheta, nphi = 90, 180
    dtheta = np.pi / ntheta
    dphi = 2.0 * np.pi / nphi

    tmp = jnp.arange(cnt, dtype=ft) / cnt
    theta_k = tmp * ft.type(0.5 * np.pi)
    cos_k = jnp.cos(theta_k)
    sin_k = jnp.sin(theta_k)

    u_i = jnp.arange(ntheta, dtype=ft) / ntheta
    theta_h = u_i * u_i * ft.type(np.pi * 0.5)
    sin_h = jnp.sin(theta_h)
    cos_h = jnp.cos(theta_h)
    u_j = jnp.arange(nphi, dtype=ft) / nphi
    phi_h = u_j * ft.type(2.0 * np.pi)

    # ndf at standard params: p22_radial(tan^2) / cos^4 (dj_brdf.h:1559-1587)
    r = jnp.tan(theta_h)
    uu = jnp.sqrt(2.0 * jnp.arctan(r) / jnp.pi)
    ndf_h = spline.eval1d(p22, uu, wrap="edge") / cos_h ** 4  # (ntheta,)

    # kh[k, j2, j1]
    kh = (sin_k[:, None, None] * (sin_h * jnp.cos(phi_h)[:, None])[None, :, :]
          + (cos_k[:, None] * cos_h[None, :])[:, None, :])
    integrand = jnp.maximum(0.0, kh) * (ndf_h * u_i * sin_h)[None, None, :]
    nint = jnp.sum(integrand, axis=(1, 2)) * ft.type(dtheta) * ft.type(dphi)
    sigma = jnp.maximum(cos_k, nint)
    return jnp.concatenate([sigma, sigma[-1:]])


def compute_fresnel(brdf, p22: jnp.ndarray, sigma: jnp.ndarray,
                    res: int, shadow: bool = True) -> jnp.ndarray:
    """Average measured/microfacet ratio per theta_d with i pinned to
    the normal (reference tabular::compute_fresnel, dj_brdf.h:2583-2641
    including the 'XXX hack' at :2609). Returns (res, 3) spline points."""
    eval_fn, model = as_model_eval(brdf)
    return _fresnel_points(eval_fn, model, p22, sigma, res, shadow)


def _fresnel_points(eval_fn, model, p22, sigma, res, shadow):
    dist = Tabular(p22=p22, sigma=sigma, cdf=jnp.zeros_like(p22),
                   qf=jnp.zeros_like(p22))
    return fresnel_ratio_points(eval_fn, model, dist, res, shadow, p22.dtype)


def fresnel_ratio_points(eval_fn, model, dist, res, shadow, dtype):
    """Shared Fresnel-extraction core (reference compute_fresnel,
    dj_brdf.h:2583-2641): per-theta_d average of measured/microfacet
    ratios with i pinned to the normal (the reference's "XXX hack",
    :2609), ratios capped at 1. ``dist`` is the microfacet proxy the
    ratio divides by — the iso Tabular or a TabularAnisotropic."""
    ft = jnp.dtype(dtype)
    cnt = res - 1
    params = MicrofacetParams.standard()
    ideal = fresnel_mod.Ideal()

    tmp = jnp.arange(cnt, dtype=ft) / cnt
    theta_d = tmp * ft.type(np.pi * 0.5)  # (cnt,)

    # the reference's j-loop runs while theta_h(j-1) < pi/2 - theta_d,
    # recomputing theta_h(j) in the body; so j participates iff
    # theta_h(j-1) < pi/2 - theta_d (and theta_h(j) <= pi/2)
    nj = 2 * cnt
    j = jnp.arange(nj, dtype=ft)
    theta_h = (j / cnt) ** 2 * ft.type(np.pi * 0.5)  # (nj,)
    theta_h_prev = jnp.concatenate([jnp.zeros(1, ft), theta_h[:-1]])
    half_pi = ft.type(np.pi * 0.5)
    active = (theta_h_prev[None, :] < (half_pi - theta_d[:, None])) \
        & (theta_h[None, :] <= half_pi)  # (cnt, nj)

    # (cnt, nj) direction pairs via hd -> io, then i := z (the hack)
    TH = jnp.broadcast_to(theta_h[None, :], (cnt, nj))
    TD = jnp.broadcast_to(theta_d[:, None], (cnt, nj))
    dir_h = from_spherical(TH, jnp.zeros_like(TH))
    dir_d = from_spherical(TD, jnp.full_like(TD, ft.type(np.pi * 0.5)))
    _, dir_o = hd_to_io(dir_h, dir_d)
    dir_i = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], ft), dir_o.shape)

    fr1 = eval_fn(model, dir_i, dir_o).astype(ft)             # (cnt, nj, 3)
    fr2 = mf.eval(dist, ideal, params, dir_i, dir_o, shadow)  # (cnt, nj, 3)

    ok = active[..., None] & (fr2 > 1e-4)
    ratio = jnp.where(ok, fr1 / jnp.where(ok, fr2, 1.0), 0.0)
    count = jnp.sum(ok, axis=1)                       # (cnt, 3)
    total = jnp.sum(ratio, axis=1)                    # (cnt, 3)
    avg = jnp.where(count == 0, 1.0,
                    jnp.minimum(1.0, total / jnp.maximum(count, 1)))
    return jnp.concatenate([avg, avg[-1:]], axis=0)   # copy last row


def compute_cdf(p22: jnp.ndarray) -> jnp.ndarray:
    """Cumulative radial slope CDF (reference tabular::compute_cdf,
    dj_brdf.h:2705-2727)."""
    ft = p22.dtype
    cnt = p22.shape[0] - 1
    dtheta = np.pi / cnt
    u = jnp.arange(cnt, dtype=ft) / cnt
    theta_h = u * u * ft.type(np.pi * 0.5)
    cos_h = jnp.cos(theta_h)
    r_h = jnp.tan(theta_h)
    uu = jnp.sqrt(2.0 * jnp.arctan(r_h) / jnp.pi)
    p22_r = spline.eval1d(p22, uu, wrap="edge")
    terms = (u * r_h * p22_r) / (cos_h * cos_h)
    cdf = jnp.cumsum(terms) * ft.type(dtheta * 2.0 * np.pi)
    return jnp.concatenate([cdf, jnp.ones(1, ft)])


def compute_qf(cdf: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF scan at 8x resolution (reference tabular::compute_qf,
    dj_brdf.h:2731-2762)."""
    ft = cdf.dtype
    cnt = cdf.shape[0] - 1
    res_inv = cnt * 8
    u = jnp.arange(res_inv, dtype=ft) / res_inv
    theta_h = u * ft.type(np.pi * 0.5)
    r = jnp.tan(theta_h)
    # cdf_radial lookup (dj_brdf.h:2164-2169)
    uu = jnp.maximum(jnp.arctan(r) * 2.0 / jnp.pi, 0.0)
    cdf_vals = spline.eval1d(cdf, jnp.sqrt(uu), wrap="edge")

    targets = jnp.arange(1, cnt, dtype=ft) / cnt
    idx = jnp.searchsorted(cdf_vals, targets, side="left")
    qf_mid = jnp.where(idx >= res_inv, 1.0,
                       jnp.take(u, jnp.minimum(idx, res_inv - 1)))
    return jnp.concatenate([jnp.zeros(1, ft), qf_mid, jnp.ones(1, ft)])


def build_tabular(brdf, res: int, shadow: bool = True, use_jit: bool = True):
    """Full pipeline (reference tabular::tabular ctor, dj_brdf.h:2215-2236).

    ``brdf``: a model pytree with ``.eval`` (preferred — its tables are
    jit arguments) or a bare ``eval_fn(i, o)``. The device-side stages
    (kernel-matrix build; normalize/sigma/fresnel/cdf/qf) are
    jit-compiled as two fused programs; only the 4-step power iteration
    runs on host in float64 (an 89x89 matvec, matching the reference's
    double-precision ``matrix`` class).

    Returns ``(Tabular, SplineFresnel)``."""
    import jax

    eval_fn, model = as_model_eval(brdf)

    def stage1(model):
        return _kernel_matrix(eval_fn, model, res)

    def stage2(model, p22_raw):
        p22, nint = normalize_p22(p22_raw, return_nint=True)
        sigma = compute_sigma(p22)
        fres_pts = _fresnel_points(eval_fn, model, p22, sigma, res, shadow)
        cdf = compute_cdf(p22)
        qf = compute_qf(cdf)
        return p22, sigma, cdf, qf, fres_pts, nint

    if use_jit:
        stage1 = jax.jit(stage1)
        stage2 = jax.jit(stage2)

    K = stage1(model)
    p22_raw = _power_iteration(K)
    p22, sigma, cdf, qf, fres_pts, nint = stage2(model, p22_raw)
    # DJB_LOG parity: the reference logs the normalization constant
    # (dj_brdf.h:2302) — surfaced here at debug level
    import logging
    if (not isinstance(nint, jax.core.Tracer)
            and config.logger.isEnabledFor(logging.DEBUG)):
        config.logger.debug("tabular: normalize_p22 nint = %.9g", float(nint))
    dist = Tabular(p22=p22, sigma=sigma, cdf=cdf, qf=qf)
    return dist, fresnel_mod.SplineFresnel(points=fres_pts)


def microfacet_eval_fn(dist, fres, params, shadow: bool = True):
    """Adapter: a microfacet distribution as a plain eval_fn (the
    harness' fixed_params_brdf equivalent)."""
    def eval_fn(i, o):
        return mf.eval(dist, fres, params, i, o, shadow)
    return eval_fn
