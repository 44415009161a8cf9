"""Structure-of-arrays fast path for the GGX hot loop.

The general microfacet path (:mod:`dj_brdf_tpu.microfacet.brdf`) works
on (..., 3) direction arrays. This module works on flat component
arrays instead (no 3-wide minor axis, no slice/concat traffic); it is
the formulation used by the benchmark and the batch fitter: plain f32
component arrays, GGX + Schlick specialization of evalp (the reference's
F*D*G/(4 o.z) chain, dj_brdf.h:1529-1547, with the closed-form GGX
sigma sigma(k) = (|warp(k)| + c)/2), and the relative-L2 fitting loss.

Semantics match ``mf.evalp(GGX(), Schlick(f0), params, i, o)`` to f32
rounding (tested), including the horizon/validity gates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ggx_evalp_soa(pvec, ix, iy, iz, ox, oy, oz, with_pdf: bool = False,
                  fresnel_fn=None):
    """GGX+Schlick evalp on component arrays.

    ``pvec``: (8,) = [ax, ay, rho, txn, tyn, f0r, f0g, f0b] (already in
    constrained space); rows broadcast, so (8, N) carries per-sample
    parameters (textured roughness). Returns (r, g, b) component
    arrays; with ``with_pdf`` also the VNDF sampler's density
    D/(4 sigma(o)) at (i, o) (reference microfacet::pdf,
    dj_brdf.h:1713-1730) — the MIS counter-pdf for envmap next-event
    estimation, nearly free here because D and sigma(o) are already in
    registers. ``fresnel_fn(cos_d) -> (Fr, Fg, Fb)`` overrides the
    Schlick-from-pvec Fresnel (conductor materials)."""
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    if fresnel_fn is None:
        f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]
    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    # scalar reciprocals hoisted out of the per-element chain
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s

    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-24))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    def sigma(kx, ky, kz):
        # warp + closed-form GGX sigma_std (dj_brdf.h:1620-1631, 2062-2065)
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        nrm = jnp.sqrt(a * a + b * b + c * c)
        return (nrm + c) * 0.5, c

    si, ci = sigma(ix, iy, iz)
    so, co = sigma(ox, oy, oz)
    g1i = jnp.where((ci > 0) & (jnp.abs(si) >= 1e-12), iz / jnp.where(jnp.abs(si) < 1e-12, 1.0, si), 0.0)
    g1o = jnp.where((co > 0) & (jnp.abs(so) >= 1e-12), oz / jnp.where(jnp.abs(so) < 1e-12, 1.0, so), 0.0)
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    g = jnp.where((tmp > 0) & (jnp.abs(den) >= 1e-12),
                  tmp / jnp.where(jnp.abs(den) < 1e-12, 1.0, den), 0.0)

    # ndf (dj_brdf.h:1559-1587): slopes, affine warp, GGX p22 — one
    # per-element reciprocal (inv_hz) covers slopes and the cos^4
    valid_h = hz > 1e-4
    inv_hz = 1.0 / jnp.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    x_ = sx * inv_ax
    y_ = (ax * sy - ay_rho * sx) * inv_axays
    r2 = x_ * x_ + y_ * y_
    t1 = 1.0 + r2
    inv_hz2 = inv_hz * inv_hz
    d_num = (1.0 / jnp.pi) * inv_axays * (inv_hz2 * inv_hz2)
    d = jnp.where(valid_h, d_num / (t1 * t1), 0.0)

    cosd = jnp.clip(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1

    oz4 = 4.0 * oz
    base = jnp.where((g > 0) & (jnp.abs(oz4) >= 1e-12),
                     d * g / jnp.where(jnp.abs(oz4) < 1e-12, 1.0, oz4), 0.0)
    if fresnel_fn is None:
        Fr = f0r + c5 * (1.0 - f0r)
        Fg = f0g + c5 * (1.0 - f0g)
        Fb = f0b + c5 * (1.0 - f0b)
    else:
        Fr, Fg, Fb = fresnel_fn(cosd)
    r = Fr * base
    gg = Fg * base
    b = Fb * base
    if with_pdf:
        # gates match the sampler's own pdf output (evalp_is): a lane
        # where the VNDF sampler would report pdf 0 (receiver below
        # the warped horizon or Smith-G gated) must also see counter-
        # pdf 0, or the two MIS strategies' weights stop summing to 1
        # at those edge lanes
        okp = (co > 0) & (so > 1e-12) & (iz > 0) & (g > 0)
        pdf = jnp.where(okp,
                        0.25 * d / jnp.where(okp, so, 1.0), 0.0)
        return r, gg, b, pdf
    return r, gg, b


def beckmann_evalp_soa(pvec, ix, iy, iz, ox, oy, oz,
                       with_pdf: bool = False, fresnel_fn=None):
    """Beckmann+Schlick evalp on component arrays — the Beckmann
    counterpart of :func:`ggx_evalp_soa` (reference F*D*G/(4 o.z),
    dj_brdf.h:1529-1547, with the erf-based sigma_std 1871-1879 and
    Gaussian p22 1866-1869). ``pvec`` rows broadcast: pass (8,) for a
    uniform material or (8, N) for per-sample parameters. ``with_pdf``
    and ``fresnel_fn`` as in :func:`ggx_evalp_soa`."""
    from dj_brdf_tpu.core.special import erf

    sqrt_pi_inv = 0.5641895835477563
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    if fresnel_fn is None:
        f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]
    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s

    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-24))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inrm = jax.lax.rsqrt(jnp.maximum(q, 1e-24))
        nrm = q * inrm
        c_std = c * inrm
        sin_k = jnp.sqrt(jnp.maximum(1.0 - c_std * c_std, 1e-24))
        nu = c_std / jnp.maximum(sin_k, 1e-12)
        sig_std = (c_std * (1.0 + erf(nu))
                   + sin_k * jnp.exp(-nu * nu) * sqrt_pi_inv) * 0.5
        sig_std = jnp.where(c_std >= 1.0, 1.0, sig_std)
        return nrm * sig_std, c

    si, ci = sigma(ix, iy, iz)
    so, co = sigma(ox, oy, oz)
    g1i = jnp.where((ci > 0) & (jnp.abs(si) >= 1e-12),
                    iz / jnp.where(jnp.abs(si) < 1e-12, 1.0, si), 0.0)
    g1o = jnp.where((co > 0) & (jnp.abs(so) >= 1e-12),
                    oz / jnp.where(jnp.abs(so) < 1e-12, 1.0, so), 0.0)
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    g = jnp.where((tmp > 0) & (jnp.abs(den) >= 1e-12),
                  tmp / jnp.where(jnp.abs(den) < 1e-12, 1.0, den), 0.0)

    valid_h = hz > 1e-4
    inv_hz = 1.0 / jnp.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    x_ = sx * inv_ax
    y_ = (ax * sy - ay_rho * sx) * inv_axays
    r2 = x_ * x_ + y_ * y_
    inv_hz2 = inv_hz * inv_hz
    d = jnp.where(valid_h,
                  (1.0 / jnp.pi) * inv_axays * (inv_hz2 * inv_hz2)
                  * jnp.exp(-r2), 0.0)

    cosd = jnp.clip(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1

    oz4 = 4.0 * oz
    base = jnp.where((g > 0) & (jnp.abs(oz4) >= 1e-12),
                     d * g / jnp.where(jnp.abs(oz4) < 1e-12, 1.0, oz4), 0.0)
    if fresnel_fn is None:
        Fr = f0r + c5 * (1.0 - f0r)
        Fg = f0g + c5 * (1.0 - f0g)
        Fb = f0b + c5 * (1.0 - f0b)
    else:
        Fr, Fg, Fb = fresnel_fn(cosd)
    r = Fr * base
    gg = Fg * base
    b = Fb * base
    if with_pdf:
        # same sampler-matched gating as ggx_evalp_soa
        okp = (co > 0) & (so > 1e-12) & (iz > 0) & (g > 0)
        pdf = jnp.where(okp,
                        0.25 * d / jnp.where(okp, so, 1.0), 0.0)
        return r, gg, b, pdf
    return r, gg, b


def raw_to_pvec(raw):
    """RawFit (unconstrained, see fit.lsq) -> constrained (8,) pvec."""
    return jnp.stack([
        jnp.exp(raw.log_ax) + 1e-4,
        jnp.exp(raw.log_ay) + 1e-4,
        0.99 * jnp.tanh(raw.raw_rho),
        raw.txn, raw.tyn,
        jax.nn.sigmoid(raw.logit_f0[0]),
        jax.nn.sigmoid(raw.logit_f0[1]),
        jax.nn.sigmoid(raw.logit_f0[2]),
    ])


def ggx_lsq_loss_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                     eps: float = 1e-2):
    """Relative-L2 fitting loss on component arrays (mean over samples
    and channels, matching fit.lsq.relative_l2)."""
    r, g, b = ggx_evalp_soa(pvec, ix, iy, iz, ox, oy, oz)
    lr = (r - tr) / (tr + eps)
    lg = (g - tg) / (tg + eps)
    lb = (b - tb) / (tb + eps)
    return (jnp.mean(lr * lr) + jnp.mean(lg * lg) + jnp.mean(lb * lb)) / 3.0


def beckmann_lsq_loss_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                          eps: float = 1e-2):
    """Beckmann counterpart of :func:`ggx_lsq_loss_soa`."""
    r, g, b = beckmann_evalp_soa(pvec, ix, iy, iz, ox, oy, oz)
    lr = (r - tr) / (tr + eps)
    lg = (g - tg) / (tg + eps)
    lb = (b - tb) / (tb + eps)
    return (jnp.mean(lr * lr) + jnp.mean(lg * lg) + jnp.mean(lb * lb)) / 3.0


def split_dirs(i, o):
    """(..., 3) pairs -> component arrays."""
    return (i[..., 0], i[..., 1], i[..., 2],
            o[..., 0], o[..., 1], o[..., 2])


def ggx_evalp_is_soa(pvec, u1, u2, ox, oy, oz, caps: bool = True,
                     fresnel_fn=None):
    """Fused GGX VNDF sample + importance-sampled eval on component
    arrays: one pass produces (wr, wg, wb, ix, iy, iz, pdf), the SoA
    equivalent of ``mf.evalp_is(GGX*(), Schlick(f0), params, ...)``
    (reference microfacet::evalp_is, dj_brdf.h:1734-1765).

    The fusion wins come from sharing what the layered path computes
    up to three times: the receiver warp (its norm IS sigma(o), so
    G1o and the VNDF denominator are free), the sampled slopes (the
    *standard* slopes give p22_std directly, and the *warped* slopes
    are h's slope coordinates, so D needs no h re-projection), and
    G/G1o collapsing to g1i/den.

    ``caps=True`` samples via the spherical-cap construction
    (GGXSphericalCaps — identical VNDF); ``caps=False`` uses the
    reference's closed-form qf2 + rational qf3 (dj_brdf.h:2089-2146).

    One deliberate edge-case difference from the layered path: for
    receivers below the mean-normal horizon (warped o.z <= 0, where
    the reference emits an arbitrary "up" sample) this returns
    weight = pdf = 0 instead of the up-sample's evaluated weight.
    """
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    if fresnel_fn is None:
        f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]
    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_axays = 1.0 / (ax * ay * s)

    u1 = jnp.clip(u1, 0.0, 1.0) * 0.99998 + 0.00001
    u2 = jnp.clip(u2, 0.0, 1.0) * 0.99998 + 0.00001

    # receiver warp into the standard frame (dj_brdf.h:1686-1689);
    # |warp(o)| recurs as sigma(o) = (nrm + c)/2
    a_o = ox * ax + oy * ay * rho
    b_o = oy * ay * s
    c_o = oz - ox * txn - oy * tyn
    q_o = a_o * a_o + b_o * b_o + c_o * c_o
    inrm_o = jax.lax.rsqrt(jnp.maximum(q_o, 1e-24))
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0
    sig_o = (q_o * inrm_o + c_o) * 0.5

    if caps:
        # spherical-cap VNDF sampling (arXiv:2306.05044)
        phi = (2.0 * jnp.pi) * u1
        z = (1.0 - u2) * (1.0 + kz) - kz
        sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
        hx_c = sin_t * jnp.cos(phi) + kx
        hy_c = sin_t * jnp.sin(phi) + ky
        hz_c = jnp.maximum(z + kz, 1e-12)
        inv_hz_c = 1.0 / hz_c
        tx_m = -hx_c * inv_hz_c
        ty_m = -hy_c * inv_hz_c
    else:
        # reference qf2 (4-branch closed form) + qf3 (rational)
        from dj_brdf_tpu.microfacet.ndf import GGX as _GGX
        g = _GGX()
        sin_k = jnp.sqrt(jnp.maximum(1.0 - kz * kz, 1e-24))
        tx = g.qf2_radial(u1, kz, sin_k)
        ty = g.qf3_radial(u2, tx)
        ni = sin_k <= 1e-9  # floored sqrt: exact normal
        #   incidence reads 1e-12, never 0; an == 0 test
        #   would go dead and zero the azimuthal frame
        nrm = jax.lax.rsqrt(jnp.maximum(kx * kx + ky * ky, 1e-24))
        cos_pk = jnp.where(ni, 1.0, kx * nrm)
        sin_pk = jnp.where(ni, 0.0, ky * nrm)
        tx_m = cos_pk * tx - sin_pk * ty
        ty_m = sin_pk * tx + cos_pk * ty

    # Cholesky unwarp + mean-normal offset (dj_brdf.h:1697-1703);
    # the warped slopes ARE h's slope coordinates
    tx_h = ax * tx_m + txn
    ty_h = ay * (rho * tx_m + s * ty_m) + tyn
    q_h = tx_h * tx_h + ty_h * ty_h + 1.0
    hn = jax.lax.rsqrt(q_h)
    hx, hy, hz = -tx_h * hn, -ty_h * hn, hn

    oh = ox * hx + oy * hy + oz * hz
    ix = 2.0 * oh * hx - ox
    iy = 2.0 * oh * hy - oy
    iz = 2.0 * oh * hz - oz

    # sigma(i) for the Smith GAF
    a_i = ix * ax + iy * ay * rho
    b_i = iy * ay * s
    c_i = iz - ix * txn - iy * tyn
    q_i = a_i * a_i + b_i * b_i + c_i * c_i
    inrm_i = jax.lax.rsqrt(jnp.maximum(q_i, 1e-24))
    sig_i = (q_i * inrm_i + c_i) * 0.5

    ok_i = (c_i > 0) & (jnp.abs(sig_i) >= 1e-12)
    ok_o = (c_o > 0) & (jnp.abs(sig_o) >= 1e-12)
    g1i = jnp.where(ok_i, iz * (1.0 / jnp.where(ok_i, sig_i, 1.0)), 0.0)
    g1o = jnp.where(ok_o, oz * (1.0 / jnp.where(ok_o, sig_o, 1.0)), 0.0)
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (jnp.abs(den) >= 1e-12)
    inv_den = jnp.where(ok_g, 1.0 / jnp.where(ok_g, den, 1.0), 0.0)

    # weight = F * G / G1o = F * g1i / den (dj_brdf.h:1760)
    w_s = g1i * inv_den
    cosd = jnp.clip(oh, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1
    ok = valid & ok_g & (tmp * inv_den > 0.0)
    w_s = jnp.where(ok, w_s, 0.0)
    if fresnel_fn is None:
        Fr = f0r + c5 * (1.0 - f0r)
        Fg = f0g + c5 * (1.0 - f0g)
        Fb = f0b + c5 * (1.0 - f0b)
    else:
        Fr, Fg, Fb = fresnel_fn(cosd)
    wr = Fr * w_s
    wg = Fg * w_s
    wb = Fb * w_s

    # pdf = vndf(o) / (4 cosd) = D / (4 sigma(o)): the <o,h> factors
    # cancel, and 1/cos^4(theta_h) = q_h^2 (h was built from slopes)
    t1_m = 1.0 + tx_m * tx_m + ty_m * ty_m
    inv_t1m = 1.0 / t1_m
    d_ = ((1.0 / jnp.pi) * inv_axays) * q_h * q_h * (inv_t1m * inv_t1m)
    ok_p = ok & (oh > 0.0) & (jnp.abs(sig_o) >= 1e-12)
    pdf = jnp.where(ok_p,
                    0.25 * d_ * (1.0 / jnp.where(ok_p, sig_o, 1.0)), 0.0)

    up_ix = jnp.zeros_like(ix)
    ix = jnp.where(valid, ix, up_ix)
    iy = jnp.where(valid, iy, up_ix)
    iz = jnp.where(valid, iz, jnp.ones_like(iz))
    return wr, wg, wb, ix, iy, iz, pdf


def beckmann_evalp_is_soa(pvec, u1, u2, ox, oy, oz,
                          fresnel_fn=None):
    """Fused Beckmann VNDF sample + importance-sampled eval on
    component arrays — the render hot loop of the LEAN/conductor path
    (reference dj_beckmannconductor.cpp:371 -> microfacet::evalp_is
    dj_brdf.h:1734-1765 with beckmann::qf2 1897-1952). Same contract
    as :func:`ggx_evalp_is_soa`; Beckmann differs in the visible-slope
    solver (lockstep safeguarded Halley in *slope* space,
    ndf.beckmann_qf2_slope_domain — each step is exp + erf-poly, no
    erfinv) and the erf-based sigma_std. The receiver's erf(cot) /
    e^{-cot^2} pair is computed once and shared between sigma_std(o)
    and the solver's CDF normalization."""
    from dj_brdf_tpu.core.special import erf, erfinv
    sqrt_pi_inv = 0.5641895835477563
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    if fresnel_fn is None:
        f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]
    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_axays = 1.0 / (ax * ay * s)

    u1 = jnp.clip(u1, 0.0, 1.0) * 0.99998 + 0.00001
    u2 = jnp.clip(u2, 0.0, 1.0) * 0.99998 + 0.00001

    def warp(kx, ky, kz):
        a = kx * ax + ky * ay * rho
        b = ky * ay * s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inrm = jax.lax.rsqrt(jnp.maximum(q, 1e-24))
        return a, b, c, q, inrm

    def sigma_beck(c_std, nrm):
        # nrm * sigma_std_radial(c_std) (dj_brdf.h:1871-1879)
        sin_k = jnp.sqrt(jnp.maximum(1.0 - c_std * c_std, 1e-24))
        nu = c_std * (1.0 / jnp.maximum(sin_k, 1e-12))
        sig_std = (c_std * (1.0 + erf(nu))
                   + sin_k * jnp.exp(-nu * nu) * sqrt_pi_inv) * 0.5
        return nrm * jnp.where(c_std >= 1.0, 1.0, sig_std)

    a_o, b_o, c_o, q_o, inrm_o = warp(ox, oy, oz)
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0

    # receiver cot terms, shared by sigma_std(o) and the slope solver
    # (below-horizon lanes produce gated garbage either way)
    sin_k = jnp.sqrt(jnp.maximum(1.0 - kz * kz, 1e-24))
    safe_sin = jnp.maximum(sin_k, 1e-12)
    safe_cos = jnp.maximum(kz, 1e-12)
    cot = safe_cos * (1.0 / safe_sin)
    tan = sin_k * (1.0 / safe_cos)
    erf_cot = erf(cot)
    e_cot2 = jnp.exp(-cot * cot)
    sig_std_o = (kz * (1.0 + erf_cot) + sin_k * e_cot2 * sqrt_pi_inv) * 0.5
    sig_o = (q_o * inrm_o) * jnp.where(kz >= 1.0, 1.0, sig_std_o)

    # --- visible-slope Halley solve directly in slope space
    # (ndf.beckmann_qf2_slope_domain; no per-iteration erfinv)
    from dj_brdf_tpu.microfacet.ndf import beckmann_qf2_slope_domain
    tx = beckmann_qf2_slope_domain(u1, kz, sin_k,
                                   shared=(cot, tan, erf_cot, e_cot2))
    ty = erfinv(2.0 * jnp.maximum(u2, 1e-6) - 1.0)

    # rotate into the azimuthal frame of k (dj_brdf.h:1830-1842)
    ni = sin_k <= 1e-9  # floored sqrt: exact normal
    #   incidence reads 1e-12, never 0; an == 0 test
    #   would go dead and zero the azimuthal frame
    nrm_xy = jax.lax.rsqrt(jnp.maximum(kx * kx + ky * ky, 1e-24))
    cos_pk = jnp.where(ni, 1.0, kx * nrm_xy)
    sin_pk = jnp.where(ni, 0.0, ky * nrm_xy)
    tx_m = cos_pk * tx - sin_pk * ty
    ty_m = sin_pk * tx + cos_pk * ty

    tx_h = ax * tx_m + txn
    ty_h = ay * (rho * tx_m + s * ty_m) + tyn
    q_h = tx_h * tx_h + ty_h * ty_h + 1.0
    hn = jax.lax.rsqrt(q_h)
    hx, hy, hz = -tx_h * hn, -ty_h * hn, hn

    oh = ox * hx + oy * hy + oz * hz
    ix = 2.0 * oh * hx - ox
    iy = 2.0 * oh * hy - oy
    iz = 2.0 * oh * hz - oz

    a_i, b_i, c_i, q_i, inrm_i = warp(ix, iy, iz)
    sig_i = sigma_beck(c_i * inrm_i, q_i * inrm_i)

    ok_i = (c_i > 0) & (jnp.abs(sig_i) >= 1e-12)
    ok_o = (c_o > 0) & (jnp.abs(sig_o) >= 1e-12)
    g1i = jnp.where(ok_i, iz * (1.0 / jnp.where(ok_i, sig_i, 1.0)), 0.0)
    g1o = jnp.where(ok_o, oz * (1.0 / jnp.where(ok_o, sig_o, 1.0)), 0.0)
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (jnp.abs(den) >= 1e-12)
    inv_den = jnp.where(ok_g, 1.0 / jnp.where(ok_g, den, 1.0), 0.0)

    w_s = g1i * inv_den                      # F * G / G1o, F split below
    cosd = jnp.clip(oh, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1
    ok = valid & ok_g & (tmp * inv_den > 0.0)
    w_s = jnp.where(ok, w_s, 0.0)
    if fresnel_fn is None:
        Fr = f0r + c5 * (1.0 - f0r)
        Fg = f0g + c5 * (1.0 - f0g)
        Fb = f0b + c5 * (1.0 - f0b)
    else:
        Fr, Fg, Fb = fresnel_fn(cosd)
    wr = Fr * w_s
    wg = Fg * w_s
    wb = Fb * w_s

    # pdf = D / (4 sigma(o)); Beckmann p22_std = e^{-r^2}/pi
    r2_m = tx_m * tx_m + ty_m * ty_m
    d_ = ((1.0 / jnp.pi) * inv_axays) * q_h * q_h * jnp.exp(-r2_m)
    ok_p = ok & (oh > 0.0) & (jnp.abs(sig_o) >= 1e-12)
    pdf = jnp.where(ok_p,
                    0.25 * d_ * (1.0 / jnp.where(ok_p, sig_o, 1.0)), 0.0)

    zero = jnp.zeros_like(ix)
    ix = jnp.where(valid, ix, zero)
    iy = jnp.where(valid, iy, zero)
    iz = jnp.where(valid, iz, jnp.ones_like(iz))
    return wr, wg, wb, ix, iy, iz, pdf


def mixed_nee_evalp_is_soa(pvec, is_beck, lx, ly, lz, u1, u2, ox, oy, oz,
                           caps: bool = False,
                           with_nee: bool = True,
                           with_nee_pdf: bool = False,
                           fresnel_fn=None):
    """Dual-family fused NEE evalp + VNDF sample + IS weight for
    per-ray GGX/Beckmann dispatch — the mixed-material path tracer
    kernel.

    Everything family-independent — the receiver/light/sample warps,
    half-vector construction, reflection, Smith G, Fresnel, and the
    D/(4 sigma) pdf — is computed once; only the three
    distribution-specific scalars select per lane on ``is_beck``:

      * sigma_std: Beckmann erf form (dj_brdf.h:1871-1879) vs the GGX
        closed form (2062-2065)
      * p22_std(r^2): e^{-r^2}/pi vs 1/(pi (1+r^2)^2)
      * visible-slope quantiles: the erf-domain Halley solve
        (ndf.beckmann_qf2_slope_domain) vs GGX's closed-form qf2 +
        rational qf3 (2089-2146)

    so the cost is ~one Beckmann kernel instead of one Beckmann plus
    one GGX kernel. ``pvec``: (8,) or per-ray (8, N); ``is_beck``:
    bool mask. Matches the select of the two single-family kernels
    lane-for-lane (tested). ``caps`` selects the GGX lanes' sampler:
    False = the reference-qf closed form, True = the spherical-caps
    construction (same VNDF, ~25% cheaper per lane — caps slopes come
    out directly in the standard frame, skipping the qf2/qf3
    rationals). ``with_nee=False`` skips the NEE chunk and returns
    the 7-tuple (wr, wg, wb, ix, iy, iz, pdf) only (the path tracer's
    spp-deduplicated first bounce computes NEE once per pixel).
    ``fresnel_fn(cos_d) -> (Fr, Fg, Fb)`` overrides Schlick-from-pvec
    (per-lane conductor/Schlick mixes close over their own masks)."""
    from dj_brdf_tpu.core.special import erf, erfinv
    from dj_brdf_tpu.microfacet.ndf import GGX as _GGX
    from dj_brdf_tpu.microfacet.ndf import beckmann_qf2_slope_domain
    sqrt_pi_inv = 0.5641895835477563
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    if fresnel_fn is None:
        f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]
    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_ax = 1.0 / ax
    inv_axays = 1.0 / (ax * ay * s)
    ay_rho = ay * rho
    ay_s = ay * s

    def p22_sel(r2):
        t1 = 1.0 + r2
        return jnp.where(is_beck, jnp.exp(-r2), 1.0 / (t1 * t1)) / jnp.pi

    def warp_sigma(kx, ky, kz, with_shared: bool = False):
        """warp + family-selected sigma; returns (sigma, c, c_std,
        nrm*inv... ) pieces shared by G1 and the sampler. With
        ``with_shared`` also returns the (cot, tan, erf_cot, e_cot2)
        tuple the Beckmann slope solver reuses (same transcendentals
        as the Beckmann sigma_std)."""
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inrm = jax.lax.rsqrt(jnp.maximum(q, 1e-24))
        nrm = q * inrm
        c_std = c * inrm
        sin_k = jnp.sqrt(jnp.maximum(1.0 - c_std * c_std, 1e-24))
        nu = c_std * (1.0 / jnp.maximum(sin_k, 1e-12))
        erf_nu = erf(nu)
        e_nu2 = jnp.exp(-nu * nu)
        sig_beck = (c_std * (1.0 + erf_nu)
                    + sin_k * e_nu2 * sqrt_pi_inv) * 0.5
        sig_beck = jnp.where(c_std >= 1.0, 1.0, sig_beck)
        sig = jnp.where(is_beck, nrm * sig_beck, (nrm + c) * 0.5)
        if with_shared:
            tan_nu = sin_k * (1.0 / jnp.maximum(c_std, 1e-12))
            return sig, c, a, b, inrm, (sin_k, nu, tan_nu, erf_nu, e_nu2)
        return sig, c, a, b, inrm

    def g1(kz_w, sig, c):
        ok = (c > 0) & (jnp.abs(sig) >= 1e-12)
        return jnp.where(ok, kz_w * (1.0 / jnp.where(ok, sig, 1.0)), 0.0)

    def smith_g(g1i, g1o):
        tmp = g1i * g1o
        den = g1i + g1o - tmp
        ok = (tmp > 0) & (jnp.abs(den) >= 1e-12)
        return jnp.where(ok, tmp * (1.0 / jnp.where(ok, den, 1.0)), 0.0)

    def schlick(cosd):
        if fresnel_fn is not None:
            return fresnel_fn(cosd)
        c1 = 1.0 - cosd
        c2 = c1 * c1
        c5 = c2 * c2 * c1
        return (f0r + c5 * (1.0 - f0r), f0g + c5 * (1.0 - f0g),
                f0b + c5 * (1.0 - f0b))

    # shared receiver terms (+ the cot pieces the Beckmann solver reuses)
    sig_o, c_o, a_o, b_o, inrm_o, shared_o = warp_sigma(
        ox, oy, oz, with_shared=True)
    g1o = g1(oz, sig_o, c_o)

    if with_nee:
        # ---- NEE evalp at the light direction (F D G / (4 o.z)) ----
        sig_l, c_l, _, _, _ = warp_sigma(lx, ly, lz)
        g1l = g1(lz, sig_l, c_l)
        g_nee = smith_g(g1l, g1o)

        hx_n, hy_n, hz_n = lx + ox, ly + oy, lz + oz
        hn_n = jax.lax.rsqrt(jnp.maximum(
            hx_n * hx_n + hy_n * hy_n + hz_n * hz_n, 1e-24))
        hx_n, hy_n, hz_n = hx_n * hn_n, hy_n * hn_n, hz_n * hn_n
        valid_h = hz_n > 1e-4
        inv_hz = 1.0 / jnp.where(valid_h, hz_n, 1.0)
        sx = -hx_n * inv_hz - txn
        sy = -hy_n * inv_hz - tyn
        x_ = sx * inv_ax
        y_ = (ax * sy - ay_rho * sx) * inv_axays
        inv_hz2 = inv_hz * inv_hz
        d_nee = jnp.where(valid_h,
                          inv_axays * (inv_hz2 * inv_hz2)
                          * p22_sel(x_ * x_ + y_ * y_), 0.0)
        cosd_n = jnp.clip(ox * hx_n + oy * hy_n + oz * hz_n, 0.0, 1.0)
        Fr_n, Fg_n, Fb_n = schlick(cosd_n)
        oz4 = 4.0 * oz
        ok_b = (g_nee > 0) & (jnp.abs(oz4) >= 1e-12)
        base = jnp.where(ok_b,
                         d_nee * g_nee * (1.0 / jnp.where(ok_b, oz4, 1.0)),
                         0.0)
        fr, fg, fb = Fr_n * base, Fg_n * base, Fb_n * base
        if with_nee_pdf:
            # VNDF sampler density at the light direction (the MIS
            # counter-pdf): D(h)/(4 sigma(o)), dj_brdf.h:1713-1730 —
            # d_nee and sigma(o) are already in registers. The g_nee
            # gate mirrors the sampler's own pdf gating (evalp_is
            # zeroes pdf at Smith-G-gated lanes), keeping the two MIS
            # strategies' weights summing to 1 at edge lanes
            okp = ((c_o > 0) & (jnp.abs(sig_o) >= 1e-12)
                   & valid_h & (lz > 0) & (g_nee > 0))
            pdf_nee = jnp.where(
                okp, 0.25 * d_nee * (1.0 / jnp.where(okp, sig_o, 1.0)),
                0.0)

    # ---- VNDF sample + IS weight -----------------------------------
    u1 = jnp.clip(u1, 0.0, 1.0) * 0.99998 + 0.00001
    u2 = jnp.clip(u2, 0.0, 1.0) * 0.99998 + 0.00001
    kx, ky, kz = a_o * inrm_o, b_o * inrm_o, c_o * inrm_o
    valid = kz > 0.0
    sin_k, nu_o, tan_o, erf_nu_o, e_nu2_o = shared_o

    # slope quantiles: slope-space Halley (Beckmann, reusing the
    # receiver-sigma transcendentals) vs closed form / caps (GGX)
    tx_b = beckmann_qf2_slope_domain(
        u1, kz, sin_k,
        shared=(nu_o, tan_o, erf_nu_o, e_nu2_o))
    ty_b = erfinv(2.0 * jnp.maximum(u2, 1e-6) - 1.0)
    ni = sin_k <= 1e-9  # floored sqrt: exact normal
    #   incidence reads 1e-12, never 0; an == 0 test
    #   would go dead and zero the azimuthal frame
    nrm_xy = jax.lax.rsqrt(jnp.maximum(kx * kx + ky * ky, 1e-24))
    cos_pk = jnp.where(ni, 1.0, kx * nrm_xy)
    sin_pk = jnp.where(ni, 0.0, ky * nrm_xy)
    tx_mb = cos_pk * tx_b - sin_pk * ty_b
    ty_mb = sin_pk * tx_b + cos_pk * ty_b
    if caps:
        # spherical-cap construction (arXiv:2306.05044): standard-frame
        # slopes directly, no radial-frame rotation
        phi = (2.0 * jnp.pi) * u1
        z = (1.0 - u2) * (1.0 + kz) - kz
        sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
        hz_c = jnp.maximum(z + kz, 1e-12)
        inv_hz_c = 1.0 / hz_c
        tx_mg = -(sin_t * jnp.cos(phi) + kx) * inv_hz_c
        ty_mg = -(sin_t * jnp.sin(phi) + ky) * inv_hz_c
    else:
        _g = _GGX()
        tx_g = _g.qf2_radial(u1, kz, sin_k)
        ty_g = _g.qf3_radial(u2, tx_g)
        tx_mg = cos_pk * tx_g - sin_pk * ty_g
        ty_mg = sin_pk * tx_g + cos_pk * ty_g
    tx_m = jnp.where(is_beck, tx_mb, tx_mg)
    ty_m = jnp.where(is_beck, ty_mb, ty_mg)

    tx_h = ax * tx_m + txn
    ty_h = ay * (rho * tx_m + s * ty_m) + tyn
    q_h = tx_h * tx_h + ty_h * ty_h + 1.0
    hn = jax.lax.rsqrt(q_h)
    hx, hy, hz = -tx_h * hn, -ty_h * hn, hn

    oh = ox * hx + oy * hy + oz * hz
    ix = 2.0 * oh * hx - ox
    iy = 2.0 * oh * hy - oy
    iz = 2.0 * oh * hz - oz

    sig_i, c_i, _, _, _ = warp_sigma(ix, iy, iz)
    g1i = g1(iz, sig_i, c_i)
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (jnp.abs(den) >= 1e-12)
    inv_den = jnp.where(ok_g, 1.0 / jnp.where(ok_g, den, 1.0), 0.0)

    w_s = g1i * inv_den
    cosd = jnp.clip(oh, 0.0, 1.0)
    ok = valid & ok_g & (tmp * inv_den > 0.0)
    w_s = jnp.where(ok, w_s, 0.0)
    Fr, Fg, Fb = schlick(cosd)
    wr, wg, wb = Fr * w_s, Fg * w_s, Fb * w_s

    d_ = inv_axays * q_h * q_h * p22_sel(tx_m * tx_m + ty_m * ty_m)
    ok_p = ok & (oh > 0.0) & (jnp.abs(sig_o) >= 1e-12)
    pdf = jnp.where(ok_p,
                    0.25 * d_ * (1.0 / jnp.where(ok_p, sig_o, 1.0)), 0.0)

    zero = jnp.zeros_like(ix)
    ix = jnp.where(valid, ix, zero)
    iy = jnp.where(valid, iy, zero)
    iz = jnp.where(valid, iz, jnp.ones_like(iz))
    if not with_nee:
        return wr, wg, wb, ix, iy, iz, pdf
    if with_nee_pdf:
        return fr, fg, fb, pdf_nee, wr, wg, wb, ix, iy, iz, pdf
    return fr, fg, fb, wr, wg, wb, ix, iy, iz, pdf


def ggx_lsq_fwdbwd_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                       eps: float = 1e-2, stack=jnp.stack):
    """Hand-written forward + adjoint of the fitting loss.

    Returns ``(loss_sum, grad(8,))`` where ``loss_sum`` is the
    per-sample channel-mean loss *summed* over samples and ``grad`` is
    its exact derivative w.r.t. ``pvec``. Dividing both by the sample
    count reproduces :func:`ggx_lsq_loss_soa` and its autodiff
    gradient (tested); the point of writing the adjoint by hand is
    that every backward term reuses a forward intermediate — no
    recomputed transcendentals, no residual round-trips — so the whole
    step is one pass over the samples (the Pallas kernel in
    `ops/fused_fit.py` runs it per block; ``stack=tuple`` there keeps
    the 8 gradient sums as scalars).

    All gates mirror :func:`ggx_evalp_soa` exactly; gated-out samples
    contribute exactly zero to every gradient component.
    """
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]

    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_ax = 1.0 / ax
    inv_ay = 1.0 / ay
    inv_s = 1.0 / s
    inv_axays = inv_ax * inv_ay * inv_s
    ay_rho = ay * rho
    ay_s = ay * s

    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-24))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inv_nrm = jax.lax.rsqrt(jnp.maximum(q, 1e-24))
        nrm = q * inv_nrm
        return (nrm + c) * 0.5, a, b, c, inv_nrm

    si, a_i, b_i, c_i, inrm_i = sigma(ix, iy, iz)
    so, a_o, b_o, c_o, inrm_o = sigma(ox, oy, oz)
    ok_i = (c_i > 0) & (jnp.abs(si) >= 1e-12)
    ok_o = (c_o > 0) & (jnp.abs(so) >= 1e-12)
    inv_si = jnp.where(ok_i, 1.0 / jnp.where(ok_i, si, 1.0), 0.0)
    inv_so = jnp.where(ok_o, 1.0 / jnp.where(ok_o, so, 1.0), 0.0)
    g1i = iz * inv_si
    g1o = oz * inv_so
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (jnp.abs(den) >= 1e-12)
    inv_den = jnp.where(ok_g, 1.0 / jnp.where(ok_g, den, 1.0), 0.0)
    g = tmp * inv_den

    valid_h = hz > 1e-4
    inv_hz = 1.0 / jnp.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    u = sx * inv_ax
    v = sy * inv_ay
    y_ = (v - rho * u) * inv_s
    r2 = u * u + y_ * y_
    inv_t1 = 1.0 / (1.0 + r2)
    inv_hz2 = inv_hz * inv_hz
    d = jnp.where(valid_h,
                  ((1.0 / jnp.pi) * inv_axays) * (inv_hz2 * inv_hz2)
                  * (inv_t1 * inv_t1), 0.0)

    cosd = jnp.clip(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1

    oz4 = 4.0 * oz
    ok_b = (g > 0) & (jnp.abs(oz4) >= 1e-12)
    inv_oz4 = jnp.where(ok_b, 1.0 / jnp.where(ok_b, oz4, 1.0), 0.0)
    base = d * g * inv_oz4

    # --- loss (per-sample mean over channels) + upstream weights
    third = jnp.float32(1.0 / 3.0)
    inv_tr = 1.0 / (tr + eps)
    inv_tg = 1.0 / (tg + eps)
    inv_tb = 1.0 / (tb + eps)
    Fr = f0r + c5 * (1.0 - f0r)
    Fg = f0g + c5 * (1.0 - f0g)
    Fb = f0b + c5 * (1.0 - f0b)
    rr = (Fr * base - tr) * inv_tr
    rg = (Fg * base - tg) * inv_tg
    rb = (Fb * base - tb) * inv_tb
    loss_sum = third * jnp.sum(rr * rr + rg * rg + rb * rb)

    wr = (2.0 * third) * rr * inv_tr        # dL/dpred_c
    wg = (2.0 * third) * rg * inv_tg
    wb = (2.0 * third) * rb * inv_tb

    one_m_c5_base = (1.0 - c5) * base
    g_f0r = jnp.sum(wr * one_m_c5_base)
    g_f0g = jnp.sum(wg * one_m_c5_base)
    g_f0b = jnp.sum(wb * one_m_c5_base)

    gbase = wr * Fr + wg * Fg + wb * Fb
    gd = gbase * g * inv_oz4                # dL/dD (inv_oz4 gates)
    gg = gbase * d * inv_oz4                # dL/dG

    # --- G path: dG/dg1 = (other/den)^2; dg1/dsigma = -g1/sigma
    gG1i = gg * (g1o * inv_den) ** 2
    gG1o = gg * (g1i * inv_den) ** 2
    gsig_i = -gG1i * g1i * inv_si
    gsig_o = -gG1o * g1o * inv_so

    def sigma_bwd(gsig, a, b, c, inv_nrm, kx, ky):
        da = 0.5 * gsig * a * inv_nrm       # dL/da
        db = 0.5 * gsig * b * inv_nrm
        dc = 0.5 * gsig * (c * inv_nrm + 1.0)
        gax = da * kx
        gay = ky * (da * rho + db * s)
        grho = ky * ay * (da - db * rho * inv_s)
        gtx = -dc * kx
        gty = -dc * ky
        return gax, gay, grho, gtx, gty

    ax_i, ay_i, rho_i, tx_i, ty_i = sigma_bwd(gsig_i, a_i, b_i, c_i,
                                              inrm_i, ix, iy)
    ax_o, ay_o, rho_o, tx_o, ty_o = sigma_bwd(gsig_o, a_o, b_o, c_o,
                                              inrm_o, ox, oy)

    # --- D path: dD/dp = D * (-dlog(ax ay s)/dp - 2 dt1/dp / t1)
    S = gd * d
    q4 = 4.0 * inv_t1
    d_ax = S * inv_ax * (q4 * (u * u - y_ * rho * u * inv_s) - 1.0)
    d_ay = S * inv_ay * (q4 * y_ * v * inv_s - 1.0)
    d_rho = S * (rho * (inv_s * inv_s)
                 - q4 * y_ * (y_ * rho * (inv_s * inv_s) - u * inv_s))
    d_tx = S * q4 * inv_ax * (u - y_ * rho * inv_s)
    d_ty = S * q4 * inv_ay * inv_s * y_

    grad = stack([
        jnp.sum(ax_i + ax_o + d_ax),
        jnp.sum(ay_i + ay_o + d_ay),
        jnp.sum(rho_i + rho_o + d_rho),
        jnp.sum(tx_i + tx_o + d_tx),
        jnp.sum(ty_i + ty_o + d_ty),
        g_f0r, g_f0g, g_f0b,
    ])
    return loss_sum, grad


def beckmann_lsq_fwdbwd_soa(pvec, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                            eps: float = 1e-2, stack=jnp.stack):
    """Hand-written forward + adjoint of the Beckmann fitting loss —
    the Beckmann half of the reference's co-equal fit pair
    (fit_beckmann_parameters dj_brdf.h:3133-3158; evalp chain
    1529-1547 with the erf sigma 1866-1879). Same contract as
    :func:`ggx_lsq_fwdbwd_soa`: ``(loss_sum, grad(8,))`` with every
    backward term reusing a forward register.

    The two derivative novelties vs the GGX adjoint:

    * D path: Gaussian p22 means dlogD/dr^2 = -1 (vs -2/(1+r^2)), so
      the identical slope-chain code runs with the constant q4 = 2 in
      place of GGX's 4/(1+r^2).
    * sigma path: sigma = |warp(k)| * f(c_std) with
      f = sigma_std_beckmann; f'(t) = (1+erf nu)/2 - nu e^{-nu^2} /
      (2 sqrt(pi)) (nu = cot theta) — both transcendentals are the
      forward's own erf/exp terms, so the backward adds zero
      transcendental cost.
    """
    from dj_brdf_tpu.core.special import erf
    sqrt_pi_inv = 0.5641895835477563
    ax, ay, rho = pvec[0], pvec[1], pvec[2]
    txn, tyn = pvec[3], pvec[4]
    f0r, f0g, f0b = pvec[5], pvec[6], pvec[7]

    s = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 1e-24))
    inv_ax = 1.0 / ax
    inv_ay = 1.0 / ay
    inv_s = 1.0 / s
    inv_axays = inv_ax * inv_ay * inv_s
    ay_rho = ay * rho
    ay_s = ay * s

    hx, hy, hz = ix + ox, iy + oy, iz + oz
    hn = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-24))
    hx, hy, hz = hx * hn, hy * hn, hz * hn

    def sigma(kx, ky, kz):
        a = kx * ax + ky * ay_rho
        b = ky * ay_s
        c = kz - kx * txn - ky * tyn
        q = a * a + b * b + c * c
        inv_nrm = jax.lax.rsqrt(jnp.maximum(q, 1e-24))
        nrm = q * inv_nrm
        c_std = c * inv_nrm
        sin2 = jnp.maximum(1.0 - c_std * c_std, 1e-24)
        sin_k = jnp.sqrt(sin2)
        nu = c_std * (1.0 / jnp.maximum(sin_k, 1e-12))
        erf_nu = erf(nu)
        e_nu2 = jnp.exp(-nu * nu)
        half_1pe = 0.5 * (1.0 + erf_nu)
        f = c_std * half_1pe + 0.5 * sin_k * e_nu2 * sqrt_pi_inv
        f = jnp.where(c_std >= 1.0, 1.0, f)
        # f'(c_std); ->1 smoothly at normal incidence, 0 on the
        # guarded branch's interior is never hit (|c_std| <= 1)
        fp = half_1pe - 0.5 * nu * e_nu2 * sqrt_pi_inv
        return nrm * f, a, b, c, inv_nrm, c_std, sin2, f, fp

    (si, a_i, b_i, c_i, inrm_i, cstd_i, sin2_i, f_i, fp_i) = sigma(
        ix, iy, iz)
    (so, a_o, b_o, c_o, inrm_o, cstd_o, sin2_o, f_o, fp_o) = sigma(
        ox, oy, oz)
    ok_i = (c_i > 0) & (jnp.abs(si) >= 1e-12)
    ok_o = (c_o > 0) & (jnp.abs(so) >= 1e-12)
    inv_si = jnp.where(ok_i, 1.0 / jnp.where(ok_i, si, 1.0), 0.0)
    inv_so = jnp.where(ok_o, 1.0 / jnp.where(ok_o, so, 1.0), 0.0)
    g1i = iz * inv_si
    g1o = oz * inv_so
    tmp = g1i * g1o
    den = g1i + g1o - tmp
    ok_g = (tmp > 0) & (jnp.abs(den) >= 1e-12)
    inv_den = jnp.where(ok_g, 1.0 / jnp.where(ok_g, den, 1.0), 0.0)
    g = tmp * inv_den

    valid_h = hz > 1e-4
    inv_hz = 1.0 / jnp.where(valid_h, hz, 1.0)
    sx = -hx * inv_hz - txn
    sy = -hy * inv_hz - tyn
    u = sx * inv_ax
    v = sy * inv_ay
    y_ = (v - rho * u) * inv_s
    r2 = u * u + y_ * y_
    inv_hz2 = inv_hz * inv_hz
    d = jnp.where(valid_h,
                  ((1.0 / jnp.pi) * inv_axays) * (inv_hz2 * inv_hz2)
                  * jnp.exp(-r2), 0.0)

    cosd = jnp.clip(ox * hx + oy * hy + oz * hz, 0.0, 1.0)
    c1 = 1.0 - cosd
    c2 = c1 * c1
    c5 = c2 * c2 * c1

    oz4 = 4.0 * oz
    ok_b = (g > 0) & (jnp.abs(oz4) >= 1e-12)
    inv_oz4 = jnp.where(ok_b, 1.0 / jnp.where(ok_b, oz4, 1.0), 0.0)
    base = d * g * inv_oz4

    # --- loss + upstream weights (identical to the GGX adjoint)
    third = jnp.float32(1.0 / 3.0)
    inv_tr = 1.0 / (tr + eps)
    inv_tg = 1.0 / (tg + eps)
    inv_tb = 1.0 / (tb + eps)
    Fr = f0r + c5 * (1.0 - f0r)
    Fg = f0g + c5 * (1.0 - f0g)
    Fb = f0b + c5 * (1.0 - f0b)
    rr = (Fr * base - tr) * inv_tr
    rg = (Fg * base - tg) * inv_tg
    rb = (Fb * base - tb) * inv_tb
    loss_sum = third * jnp.sum(rr * rr + rg * rg + rb * rb)

    wr = (2.0 * third) * rr * inv_tr
    wg = (2.0 * third) * rg * inv_tg
    wb = (2.0 * third) * rb * inv_tb

    one_m_c5_base = (1.0 - c5) * base
    g_f0r = jnp.sum(wr * one_m_c5_base)
    g_f0g = jnp.sum(wg * one_m_c5_base)
    g_f0b = jnp.sum(wb * one_m_c5_base)

    gbase = wr * Fr + wg * Fg + wb * Fb
    gd = gbase * g * inv_oz4
    gg = gbase * d * inv_oz4

    # --- G path (same structure as GGX)
    gG1i = gg * (g1o * inv_den) ** 2
    gG1o = gg * (g1i * inv_den) ** 2
    gsig_i = -gG1i * g1i * inv_si
    gsig_o = -gG1o * g1o * inv_so

    def sigma_bwd(gsig, a, b, c, inv_nrm, c_std, sin2, f, fp, kx, ky):
        # sigma = nrm * f(c/nrm):
        #   d/da = (a/nrm)(f - f' c_std);  d/db likewise;
        #   d/dc = c_std f + f' sin^2
        rad = f - fp * c_std
        da = gsig * a * inv_nrm * rad
        db = gsig * b * inv_nrm * rad
        dc = gsig * (c_std * f + fp * sin2)
        gax = da * kx
        gay = ky * (da * rho + db * s)
        grho = ky * ay * (da - db * rho * inv_s)
        gtx = -dc * kx
        gty = -dc * ky
        return gax, gay, grho, gtx, gty

    ax_i, ay_i, rho_i, tx_i, ty_i = sigma_bwd(
        gsig_i, a_i, b_i, c_i, inrm_i, cstd_i, sin2_i, f_i, fp_i, ix, iy)
    ax_o, ay_o, rho_o, tx_o, ty_o = sigma_bwd(
        gsig_o, a_o, b_o, c_o, inrm_o, cstd_o, sin2_o, f_o, fp_o, ox, oy)

    # --- D path: Gaussian p22 -> q4 = 2 (dlogD/dr^2 = -1)
    S = gd * d
    q4 = 2.0
    d_ax = S * inv_ax * (q4 * (u * u - y_ * rho * u * inv_s) - 1.0)
    d_ay = S * inv_ay * (q4 * y_ * v * inv_s - 1.0)
    d_rho = S * (rho * (inv_s * inv_s)
                 - q4 * y_ * (y_ * rho * (inv_s * inv_s) - u * inv_s))
    d_tx = S * q4 * inv_ax * (u - y_ * rho * inv_s)
    d_ty = S * q4 * inv_ay * inv_s * y_

    grad = stack([
        jnp.sum(ax_i + ax_o + d_ax),
        jnp.sum(ay_i + ay_o + d_ay),
        jnp.sum(rho_i + rho_o + d_rho),
        jnp.sum(tx_i + tx_o + d_tx),
        jnp.sum(ty_i + ty_o + d_ty),
        g_f0r, g_f0g, g_f0b,
    ])
    return loss_sum, grad
