"""Anisotropic (elevation x azimuth) tabulation pipeline.

JAX version of the ``djb::tabular_anisotropic`` constructor
(dj_brdf.h:2238-2273) and its precomputations: the (w*h)^2 kernel
matrix + power iteration (2525-2579), 2D normalization (2306-2338),
2D projected-area table (2388-2432), and the marginal-azimuth /
conditional-elevation sampling tables pdf1/cdf1/qf1/pdf2/cdf2/qf2
(2848-3103).

The kernel matrix (8010^2 for the reference's 90x90 resolution) is
built as one batched device expression. Small problems (n <= 4096)
power-iterate on host in float64 for bit-level oracle parity
(the reference ``matrix`` class is always double); production sizes
stay entirely on device — the 257 MB matrix is built and multiplied
in one jitted program (4 matvecs) and never crosses the host link.
Row-sharded multi-chip extraction lives in
:mod:`dj_brdf_tpu.parallel.power`.

Table layout is (azimuthal_res, elevation_res) with the elevation axis
fast, matching the reference's flat ``m_p22[i + w*j]``. Precision
follows ``config.default_float()`` (DJB_USE_DOUBLE_PRECISION parity).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from dj_brdf_tpu import config
from dj_brdf_tpu import fresnel as fresnel_mod
from dj_brdf_tpu.core.math import from_spherical, hd_to_io
from dj_brdf_tpu.fit.tabular import as_model_eval
from dj_brdf_tpu.microfacet.ndf import TabularAnisotropic

#: n = (elevation_res-1) * azimuthal_res above which the power
#: iteration runs on device in f32 instead of host float64.
HOST_F64_MAX_N = 4096

_LUMA = (0.2126, 0.7152, 0.0722)


def _p22_query(p22_table, theta, phi):
    """p22_std_theta_phi on a raw (H, W) table (dj_brdf.h:2185-2196)."""
    d = TabularAnisotropic(
        p22=p22_table, sigma=p22_table, pdf1=p22_table[:, 0],
        cdf1=p22_table[:, 0], qf1_table=p22_table[:, 0],
        pdf2=p22_table, cdf2=p22_table, qf2_table=p22_table)
    return d.p22_std_theta_phi(theta, phi)


def kernel_matrix(brdf, elevation_res: int, azimuthal_res: int,
                  dtype=None) -> jnp.ndarray:
    """The (w*h, w*h) matrix A with A[col, row] = K(row, col) so a
    power step is ``A @ v`` (reference compute_p22_smith aniso,
    dj_brdf.h:2525-2566; matrix layout 2442-2465). Flat index is
    i2 * w + i1 (azimuth-major)."""
    eval_fn, model = as_model_eval(brdf)
    return _kernel_matrix(eval_fn, model, elevation_res, azimuthal_res,
                          dtype)


def _kernel_matrix(eval_fn, model, elevation_res: int, azimuthal_res: int,
                   dtype=None) -> jnp.ndarray:
    ft = dtype or config.default_float()
    w = elevation_res - 1
    h = azimuthal_res
    dtheta = np.sqrt(np.pi * 0.5) / w
    dphi = 2.0 * np.pi / h

    t1 = jnp.arange(w, dtype=ft) / w
    t2 = jnp.arange(h, dtype=ft) / h
    theta = t1 * ft(0.5 * np.pi)      # (w,)
    phi = t2 * ft(2.0 * np.pi)        # (h,)

    T, P = jnp.meshgrid(theta, phi)           # (h, w) azimuth-major
    sin_t = jnp.sin(T)
    zo = jnp.cos(T)
    xo = sin_t * jnp.cos(P)
    yo = sin_t * jnp.sin(P)

    d = from_spherical(T, P)
    fr_i = jnp.einsum("hwc,c->hw", eval_fn(model, d, d).astype(ft),
                      jnp.asarray(_LUMA, ft))
    kji_tmp1 = ft(dtheta * dphi) * (4.0 * fr_i * zo ** 5)   # (h, w) columns

    tan_t = jnp.tan(T)
    cos_t = jnp.cos(T)
    slope1 = -tan_t * jnp.cos(P)              # (h, w) rows
    slope2 = -tan_t * jnp.sin(P)

    # m_dot_o[row, col] = zo_col - xo_col*slope1_row - yo_col*slope2_row
    zo_f = zo.reshape(-1)
    xo_f = xo.reshape(-1)
    yo_f = yo.reshape(-1)
    s1_f = slope1.reshape(-1)
    s2_f = slope2.reshape(-1)
    m_dot_o = (zo_f[None, :] - s1_f[:, None] * xo_f[None, :]
               - s2_f[:, None] * yo_f[None, :])
    kji_tmp2 = (tan_t / (cos_t * cos_t)).reshape(-1)[:, None] \
        * jnp.maximum(0.0, m_dot_o)
    K = kji_tmp1.reshape(-1)[None, :] * kji_tmp2      # K[row, col]
    return K.T                                         # A[col, row]


def power_iteration_p22(A, elevation_res: int, azimuthal_res: int,
                        iterations: int = 4) -> jnp.ndarray:
    """Unnormalized float64 power iteration + table assembly with the
    zero elevation-edge column (dj_brdf.h:2568-2578). Returns (H, W)."""
    ft = config.default_float()
    w = elevation_res - 1
    Ah = np.asarray(A, np.float64)
    v = np.ones(Ah.shape[0], np.float64)
    for _ in range(iterations):
        v = Ah @ v
    grid = v.reshape(azimuthal_res, w)
    table = np.concatenate([grid, np.zeros((azimuthal_res, 1))], axis=1)
    return jnp.asarray(table, ft)


def _device_power_table(A, elevation_res: int, azimuthal_res: int,
                        iterations: int = 4) -> jnp.ndarray:
    """On-device power iteration (dj_brdf.h:2467-2480) in the working
    precision. Relative f32 matvec error at n~8000 is ~1e-5, well
    inside oracle tolerance; the subsequent normalization removes the
    scale anyway. That bound needs true f32 products, so the matvec
    pins HIGHEST precision (a GPU may otherwise run it in TF32)."""
    w = elevation_res - 1
    h = azimuthal_res
    v = jnp.ones((A.shape[0],), A.dtype)
    for _ in range(iterations):
        v = jnp.matmul(A, v, precision=jax.lax.Precision.HIGHEST)
    grid = v.reshape(h, w)
    return jnp.concatenate([grid, jnp.zeros((h, 1), A.dtype)], axis=1)


def normalize_p22(p22: jnp.ndarray, return_nint: bool = False):
    """(dj_brdf.h:2306-2338)."""
    ft = p22.dtype.type
    ntheta, nphi = 128, 256
    dtheta = np.sqrt(0.5 * np.pi) / ntheta
    dphi = 2.0 * np.pi / nphi
    u_t = jnp.arange(ntheta, dtype=ft) / ntheta
    u_p = jnp.arange(nphi, dtype=ft) / nphi
    theta = u_t * ft(np.sqrt(np.pi * 0.5))
    theta_sqr = theta * theta
    phi = u_p * ft(2.0 * np.pi)
    T2, P = jnp.meshgrid(theta_sqr, phi)
    Tw = jnp.meshgrid(theta, phi)[0]
    c = jnp.cos(T2)
    pdf = _p22_query(p22, T2, P)
    weight = (Tw * jnp.tan(T2)) / (c * c)
    k = jnp.sum(weight * pdf) * ft(2.0 * dtheta * dphi)
    if return_nint:
        return p22 / k, k
    return p22 / k


def compute_sigma(p22: jnp.ndarray) -> jnp.ndarray:
    """(dj_brdf.h:2388-2432). Returns (H, W)."""
    ft = p22.dtype.type
    H, W = p22.shape
    w = W - 1
    ntheta, nphi = 45, 90
    dtheta = np.sqrt(np.pi * 0.5) / ntheta
    dphi = 2.0 * np.pi / nphi

    i2 = jnp.arange(H, dtype=ft) / H
    i1 = jnp.arange(w, dtype=ft) / w
    phi_k = i2 * ft(2.0 * np.pi)          # (H,)
    theta_k = i1 * ft(0.5 * np.pi)        # (w,)

    jt = jnp.arange(ntheta, dtype=ft) / ntheta
    jp = jnp.arange(nphi, dtype=ft) / nphi
    theta_w = jt * ft(np.sqrt(np.pi * 0.5))   # (ntheta,)
    theta_sq = theta_w * theta_w
    phi = jp * ft(2.0 * np.pi)            # (nphi,)

    # ndf at standard params: p22_std(theta, phi)/cos^4 via slope angles
    T2, P = jnp.meshgrid(theta_sq, phi)           # (nphi, ntheta)
    sin_t = jnp.sin(T2)
    cos_t = jnp.cos(T2)
    # p22_std of the slopes of h(theta,phi): direction-h slopes have
    # magnitude tan(theta) at azimuth phi; p22_std(x,y) evaluates
    # p22_std_theta_phi(atan(|slope|), atan2(-y,-x)) = (theta, phi)
    ndf_h = _p22_query(p22, T2, P) / cos_t ** 4   # (nphi, ntheta)
    weight = (jnp.meshgrid(theta_w, phi)[0] * sin_t)  # theta * sin(theta^2)

    # m_dot_k[k_elev, k_azim, j_phi, j_theta]
    sin_tk = jnp.sin(theta_k)
    cos_tk = jnp.cos(theta_k)
    cos_dphi = jnp.cos(phi[None, :] - phi_k[:, None])   # (H, nphi)
    term1 = (sin_tk[:, None, None, None]
             * sin_t[None, None, :, :]
             * cos_dphi[None, :, :, None])
    term2 = cos_tk[:, None, None, None] * cos_t[None, None, :, :]
    masking = jnp.maximum(0.0, term1 + term2) * ndf_h[None, None, :, :]
    nint = jnp.sum(weight[None, None] * masking, axis=(2, 3)) \
        * ft(2.0 * dtheta * dphi)            # (w, H)
    sigma = jnp.maximum(cos_tk[:, None], nint).T     # (H, w)
    return jnp.concatenate([sigma, sigma[:, -1:]], axis=1)


def compute_pdf1(p22: jnp.ndarray) -> jnp.ndarray:
    """Marginal azimuth PDF + its normalization (dj_brdf.h:2848-2875,
    3046-3067). Returns (H,)."""
    ft = p22.dtype.type
    H = p22.shape[0]
    ntheta = 256
    dtheta = 0.5 * np.pi / ntheta
    u_p = jnp.arange(H, dtype=ft) / H
    phi = u_p * ft(2.0 * np.pi)
    u_t = jnp.arange(ntheta, dtype=ft) / ntheta
    theta = u_t * ft(0.5 * np.pi)
    T, P = jnp.meshgrid(theta, phi)
    c = jnp.cos(T)
    pdf = _p22_query(p22, T, P)
    nint = jnp.sum(pdf * jnp.tan(T) / (c * c), axis=1) * ft(dtheta)

    # normalize_pdf1: 512-pt quadrature of the *spline* of pdf1
    cnt = 512
    u = jnp.arange(cnt, dtype=ft) / cnt
    from dj_brdf_tpu.core import spline
    vals = spline.eval1d(nint, u, wrap="repeat")
    total = jnp.sum(vals) * ft(2.0 * np.pi / cnt)
    return nint / total


def compute_cdf1(pdf1: jnp.ndarray) -> jnp.ndarray:
    """(dj_brdf.h:2879-2901). Returns (H,)."""
    from dj_brdf_tpu.core import spline
    ft = pdf1.dtype.type
    H = pdf1.shape[0]
    cnt = H - 1
    dphi = 2.0 * np.pi / cnt
    u = jnp.arange(1, cnt, dtype=ft) / cnt
    vals = spline.eval1d(pdf1, u, wrap="repeat")
    inner = jnp.cumsum(vals) * ft(dphi)
    return jnp.concatenate([jnp.zeros(1, pdf1.dtype), inner,
                            jnp.ones(1, pdf1.dtype)])


def compute_qf1(cdf1: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF scan (dj_brdf.h:2905-2936). Returns (H,)."""
    from dj_brdf_tpu.core import spline
    ft = cdf1.dtype.type
    cnt = cdf1.shape[0] - 1
    res = cnt * 8
    u = jnp.arange(res, dtype=ft) / res
    cdf_vals = spline.eval1d(cdf1, u, wrap="repeat")
    targets = jnp.arange(1, cnt, dtype=ft) / cnt
    idx = jnp.searchsorted(cdf_vals, targets, side="left")
    qf_mid = jnp.where(idx >= res, 1.0, jnp.take(u, jnp.minimum(idx, res - 1)))
    return jnp.concatenate([jnp.zeros(1, cdf1.dtype), qf_mid.astype(cdf1.dtype),
                            jnp.ones(1, cdf1.dtype)])


def compute_pdf2(p22: jnp.ndarray, pdf1: jnp.ndarray) -> jnp.ndarray:
    """Conditional elevation PDF + per-azimuth normalization
    (dj_brdf.h:2945-2970, 3071-3103). Returns (H, W)."""
    from dj_brdf_tpu.core import spline
    ft = p22.dtype.type
    H, W = p22.shape
    ntheta = W - 1
    u_p = jnp.arange(H, dtype=ft) / H
    phi = u_p * ft(2.0 * np.pi)
    u_t = jnp.arange(ntheta, dtype=ft) / ntheta
    theta = u_t * ft(0.5 * np.pi)
    T, P = jnp.meshgrid(theta, phi)
    p22_v = _p22_query(p22, T, P)
    p1 = spline.eval1d(pdf1, u_p, wrap="repeat")[:, None]
    pdf2 = jnp.concatenate([p22_v / p1, jnp.zeros((H, 1), p22.dtype)],
                           axis=1)

    # normalize_pdf2: 256-pt theta quadrature of the 2D spline per phi
    nq = 256
    uq = jnp.arange(nq, dtype=ft) / nq
    theta_q = uq * ft(0.5 * np.pi)
    TQ, PQ = jnp.meshgrid(theta_q, phi)
    vals = spline.eval2d(pdf2, TQ * 2.0 / jnp.pi, PQ * 0.5 / jnp.pi,
                         wrap1="edge", wrap2="repeat")
    cq = jnp.cos(TQ)
    nint = jnp.sum(vals * jnp.tan(TQ) / (cq * cq), axis=1) \
        * ft(0.5 * np.pi / nq)
    return pdf2 / nint[:, None]


def compute_cdf2(pdf2: jnp.ndarray) -> jnp.ndarray:
    """(dj_brdf.h:2974-3001). Returns (H, W)."""
    from dj_brdf_tpu.core import spline
    ft = pdf2.dtype.type
    H, W = pdf2.shape
    ntheta = W - 1
    dtheta = 0.5 * np.pi / ntheta
    u_p = jnp.arange(H, dtype=ft) / H
    phi = u_p * ft(2.0 * np.pi)
    u_t = jnp.arange(ntheta, dtype=ft) / ntheta
    theta = u_t * ft(0.5 * np.pi)
    T, P = jnp.meshgrid(theta, phi)
    vals = spline.eval2d(pdf2, T * 2.0 / jnp.pi, P * 0.5 / jnp.pi,
                         wrap1="edge", wrap2="repeat")
    c = jnp.cos(T)
    inner = jnp.cumsum(vals * jnp.tan(T) / (c * c), axis=1) \
        * ft(dtheta)
    return jnp.concatenate([inner, jnp.ones((H, 1), pdf2.dtype)], axis=1)


def compute_qf2(cdf2: jnp.ndarray) -> jnp.ndarray:
    """Per-azimuth inverse-CDF scan (dj_brdf.h:3005-3042). Returns (H, W)."""
    from dj_brdf_tpu.core import spline
    ft = cdf2.dtype.type
    H, W = cdf2.shape
    ntheta = W - 1
    res = ntheta * 8
    u_p = jnp.arange(H, dtype=ft) / H
    phi = u_p * ft(2.0 * np.pi)
    u = jnp.arange(res, dtype=ft) / res
    theta = u * ft(0.5 * np.pi)
    T, P = jnp.meshgrid(theta, phi)
    cdf_vals = spline.eval2d(cdf2, T * 2.0 / jnp.pi, P * 0.5 / jnp.pi,
                             wrap1="edge", wrap2="repeat")  # (H, res)
    targets = jnp.arange(1, ntheta, dtype=ft) / ntheta

    def per_row(row):
        idx = jnp.searchsorted(row, targets, side="left")
        return jnp.where(idx >= res, 1.0, jnp.take(u, jnp.minimum(idx, res - 1)))

    mid = jax.vmap(per_row)(cdf_vals).astype(cdf2.dtype)  # (H, ntheta-1)
    return jnp.concatenate([jnp.zeros((H, 1), cdf2.dtype), mid,
                            jnp.ones((H, 1), cdf2.dtype)], axis=1)


def build_tabular_anisotropic(brdf, elevation_res: int,
                              azimuthal_res: int, shadow: bool = True,
                              use_jit: bool = True, power: str = "auto",
                              mesh=None):
    """Full pipeline (reference ctor dj_brdf.h:2238-2273).

    ``brdf``: a model pytree with ``.eval`` (preferred) or a bare
    ``eval_fn(i, o)``. ``power`` selects the stage-1 extraction:
    "auto" pulls small kernels (n <= HOST_F64_MAX_N) to the host for
    the reference's float64 power iteration and keeps production sizes
    (e.g. the 8010^2 matrix of the 90x90 UTIA fit) entirely on device
    (the matrix is built, iterated and discarded in one program);
    "host" / "device" force one path (parity tests compare the two).
    ``mesh``: a jax Mesh — stage 1 then never materializes more than
    n/D kernel columns per device (parallel.power.aniso_p22_sharded)
    and stage 2 runs on the gathered table; the one-call multi-chip
    extraction of SURVEY §2.4.

    Returns (TabularAnisotropic, SplineFresnel)."""
    eval_fn, model = as_model_eval(brdf)
    n = (elevation_res - 1) * azimuthal_res
    if power not in ("auto", "host", "device"):
        raise ValueError(f"power must be auto|host|device, got {power!r}")
    if mesh is not None and power != "auto":
        raise ValueError(
            "mesh= always runs the sharded f32 power stage; an explicit "
            f"power={power!r} selection would be ignored — pass power='auto'")
    on_device = (n > HOST_F64_MAX_N) if power == "auto" else \
        (power == "device")

    def stage1(model):
        A = _kernel_matrix(eval_fn, model, elevation_res, azimuthal_res)
        if on_device:
            return _device_power_table(A, elevation_res, azimuthal_res)
        return A

    def stage2(p22_raw):
        p22, nint = normalize_p22(p22_raw, return_nint=True)
        sigma = compute_sigma(p22)
        pdf1 = compute_pdf1(p22)
        cdf1 = compute_cdf1(pdf1)
        qf1 = compute_qf1(cdf1)
        pdf2 = compute_pdf2(p22, pdf1)
        cdf2 = compute_cdf2(pdf2)
        qf2 = compute_qf2(cdf2)
        return p22, sigma, pdf1, cdf1, qf1, pdf2, cdf2, qf2, nint

    if use_jit:
        stage1 = jax.jit(stage1)
        stage2 = jax.jit(stage2)

    if mesh is not None:
        from dj_brdf_tpu.parallel.power import aniso_p22_sharded
        p22_raw = aniso_p22_sharded(brdf, elevation_res, azimuthal_res,
                                    mesh).astype(config.default_float())
    else:
        out1 = stage1(model)
        p22_raw = out1 if on_device else \
            power_iteration_p22(out1, elevation_res, azimuthal_res)
    p22, sigma, pdf1, cdf1, qf1, pdf2, cdf2, qf2, nint = stage2(p22_raw)
    import logging
    if (not isinstance(nint, jax.core.Tracer)
            and config.logger.isEnabledFor(logging.DEBUG)):
        config.logger.debug("tabular_anisotropic: normalize nint = %.9g",
                            float(nint))

    dist = TabularAnisotropic(p22=p22, sigma=sigma, pdf1=pdf1, cdf1=cdf1,
                              qf1_table=qf1, pdf2=pdf2, cdf2=cdf2,
                              qf2_table=qf2)
    # fresnel: identical to the iso routine at elevation_res
    # (dj_brdf.h:2643-2701); evaluate with the anisotropic tables
    fres_pts = _compute_fresnel_aniso(eval_fn, model, dist, elevation_res,
                                      shadow, use_jit)
    return dist, fresnel_mod.SplineFresnel(points=fres_pts)


def _compute_fresnel_aniso(eval_fn, model, dist, res, shadow, use_jit):
    """Fresnel extraction against the anisotropic table — the shared
    ratio core from fit.tabular with this dist as the proxy."""
    from dj_brdf_tpu.fit.tabular import fresnel_ratio_points

    def run(model, dist):
        return fresnel_ratio_points(eval_fn, model, dist, res, shadow,
                                    dist.p22.dtype)

    if use_jit:
        run = jax.jit(run)
    return run(model, dist)
