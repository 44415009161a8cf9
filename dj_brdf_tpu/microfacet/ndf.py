"""Microfacet normal/slope distributions.

JAX versions of the reference's distribution hierarchy:
``djb::beckmann`` (dj_brdf.h:1863-2051), ``djb::ggx`` (2053-2146),
``djb::tabular`` (2148-2176, 2215-2762) and
``djb::tabular_anisotropic`` (2178-2211, 2238-3122).

Each distribution is a pytree dataclass exposing the *standard-frame*
interface consumed by :mod:`dj_brdf_tpu.microfacet.brdf`:

  * ``p22_std(x, y)``        — standard slope PDF
  * ``sigma_std(k)``         — standard projected area (microflake sigma)
  * ``sample_vp22_std(u1,u2,k)`` — visible-slope sampling (Smith VNDF
    for Beckmann/GGX; NDF ("nmap") sampling for tabulated ones)

Everything is branchless (``jnp.where`` instead of the reference's
``if`` trees) so one code path serves jit/vmap/grad. Tables in
the tabulated distributions are differentiable pytree leaves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dj_brdf_tpu.core import spline
from dj_brdf_tpu.core.math import vec3
from dj_brdf_tpu.core.pytree import pytree_dataclass, static_field
from dj_brdf_tpu.core.special import erf, erfinv

_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def beckmann_qf2_slope_domain(u, cos_theta_k, sin_theta_k,
                              iterations: int = 4, shared=None):
    """Beckmann visible-slope quantile solved directly in *slope*
    space — returns the sampled x-slope t (== erfinv of the erf-domain
    solution of dj_brdf.h:1897-1952).

    Iterating in t instead of b = erf(t) is the round-4 cost
    reformulation: the CDF value needs erf(t) + e^{-t^2}, and the A&S
    erf polynomial (core/special.py) *reuses* that same e^{-t^2} — so
    each lockstep safeguarded Halley step costs one exp + one
    reciprocal + ~10 FMA, versus the erf-domain iteration's erfinv
    (log + sqrt + 17 FMA) + exp. The final erfinv also disappears
    because t *is* the slope. Same init (the reference's fitted power
    law, 1915-1921), same |CDF - u| < 1e-5 criterion, same 4-iteration
    convergence envelope as the erf-domain Halley solver (measured on
    a 512x256 (u, theta) grid: identical converged fraction and
    residual profile), so oracle parity is unchanged.

    ``shared``: optional (cot, tan, c0, e_cot2) precomputed by the
    caller (the fused SoA kernels share them with sigma_std(o), which
    needs erf/exp of the very same cot)."""
    if shared is None:
        safe_sin = jnp.maximum(sin_theta_k, 1e-12)
        safe_cos = jnp.maximum(cos_theta_k, 1e-12)
        cot = safe_cos * (1.0 / safe_sin)
        tan = sin_theta_k * (1.0 / safe_cos)
        c0 = erf(cot)
        e_cot2 = jnp.exp(-cot * cot)
    else:
        cot, tan, c0, e_cot2 = shared

    u = jnp.maximum(u, 1e-6)
    fit = 1.0 + cos_theta_k * (-0.876 + cos_theta_k
                               * (0.4265 - 0.0594 * cos_theta_k))
    b0 = c0 - (1.0 + c0) * jnp.power(1.0 - u, fit)
    # the CDF normalization 1 + erf(cot) + tan e^{-cot^2}/sqrt(pi) is
    # >= 1 for every valid receiver; it approaches 0 only on BELOW-
    # horizon lanes that callers gate out (the mixed dual-family
    # kernel feeds unclamped cot there). The floor keeps the
    # reciprocal finite so reverse-mode through gated lanes stays
    # 0 * finite instead of 0 * inf = NaN.
    normalization = 1.0 / jnp.maximum(
        1.0 + c0 + _SQRT_PI_INV * tan * e_cot2, 1e-12)

    t0 = erfinv(jnp.maximum(-0.9999, b0))
    hi = jnp.minimum(cot, 4.0)
    return _qf2_root(iterations, u, tan, normalization, t0, hi)


@functools.partial(jax.custom_jvp, nondiff_argnums=(0,))
def _qf2_root(iterations, u, tan, normalization, t0, hi):
    """The Halley iteration core of :func:`beckmann_qf2_slope_domain`.

    The loop is UNROLLED in Python, not lax.fori_loop: an HLO while
    loop is a fusion barrier, and the iteration sits inside the fused
    sampling kernels. No convergence mask either — refining an
    already-converged lane is a ~0 step and tightens the residual tail
    (p999 1e-5 -> 3e-7); the safeguard is a clip to the root bracket
    [-3.5, min(cot, 4)], bit-equal in residual profile to the
    shrinking bisection bracket.

    Differentiation is by the IMPLICIT FUNCTION THEOREM (custom_jvp
    below), never through the unrolled iterations: the converged root
    t* of F(t; u, tan, N) = N (1 + erf t + tan e^{-t^2}/sqrt(pi)) - u
    depends only on (u, tan, N) — not on the init t0/bracket — and
    dt* = (du - F_tan dtan - F_N dN) / F_t needs just one extra exp.
    This is both more accurate than differentiating the iteration and
    the fix for an AD-graph blowup: reverse mode through 4 unrolled
    safeguarded steps inside a scan made XLA compile times explode
    (the round-4 path-tracer gradient test went from ~1 min to >20)."""
    # erf-poly constants (A&S 7.1.26), inlined so the iteration reuses
    # the step's e^{-t^2} for both the CDF's erf and its Gaussian term
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911

    t = t0
    lo = -3.5  # u >= 1e-6 => root >= erfinv(2e-6 - 1) ~ -3.36
    for _ in range(iterations):
        t = jnp.clip(t, lo, hi)
        e = jnp.exp(-t * t)
        at = jnp.abs(t)
        k = 1.0 / (1.0 + p * at)
        erf_t = jnp.sign(t) * (1.0 - (((((a5 * k + a4) * k) + a3) * k
                                       + a2) * k + a1) * k * e)
        value = normalization * (1.0 + erf_t + _SQRT_PI_INV * tan * e) - u

        dfac = 1.0 - t * tan                     # f' ∝ e (1 - t tan)
        fp = normalization * (2.0 * _SQRT_PI_INV) * e * dfac
        ok_fp = jnp.abs(fp) > 1e-20
        r = value * (1.0 / jnp.where(ok_fp, fp, 1.0))
        # Halley: f''/(2f') = (-2t(1 - t tan) - tan) / (2 (1 - t tan))
        h = (-2.0 * t * dfac - tan) * (1.0 / (
            2.0 * jnp.where(jnp.abs(dfac) > 1e-12, dfac, 1.0)))
        den = 1.0 - r * h
        ok_h = ok_fp & (den > 0.5) & (jnp.abs(dfac) > 1e-12)
        step = r * jnp.where(ok_h, 1.0 / jnp.where(ok_h, den, 1.0), 1.0)
        step = jnp.where(ok_fp, step, 0.0)
        t = t - step
    return jnp.clip(t, lo, hi)


@_qf2_root.defjvp
def _qf2_root_jvp(iterations, primals, tangents):
    u, tan, normalization, t0, hi = primals
    du, dtan, dnorm, _, _ = tangents  # the root is init/bracket-free
    t = _qf2_root(iterations, u, tan, normalization, t0, hi)
    e = jnp.exp(-t * t)
    # F_t = N (2/sqrt(pi)) e (1 - t tan)  (>= 0; -> 0 in the flat tail,
    # where the true quantile sensitivity genuinely diverges). The
    # floor is deliberate source-level gradient clipping: it bounds
    # the amplification of tail lanes (u within ~1e-5 of 1, where the
    # SoA kernels clamp u anyway) at 1e3x instead of letting single
    # samples dominate a render gradient with 1e6-scale fireflies;
    # interior-lane gradients (FD-verified) are unaffected.
    ft = normalization * (2.0 * _SQRT_PI_INV) * e * (1.0 - t * tan)
    ft = jnp.maximum(ft, 1e-3)
    f_tan = normalization * _SQRT_PI_INV * e
    f_norm = u * (1.0 / jnp.maximum(normalization, 1e-30))  # (1+erf t+..)
    dt = (du - f_tan * dtan - f_norm * dnorm) * (1.0 / ft)
    return t, dt


def _sample_smith_radial(dist, u1, u2, k):
    """Rotate standard visible slopes into the azimuthal frame of k
    (reference radial::sample_vp22_std_smith, dj_brdf.h:1818-1846)."""
    cos_theta_k = k[..., 2]
    sin_theta_k = jnp.sqrt(jnp.maximum(1.0 - cos_theta_k * cos_theta_k, 1e-24))
    tx = dist.qf2_radial(u1, cos_theta_k, sin_theta_k)
    ty = dist.qf3_radial(u2, tx)

    normal_incidence = sin_theta_k <= 1e-9  # floored sqrt: never == 0
    nrm = jax.lax.rsqrt(jnp.maximum(k[..., 0] ** 2 + k[..., 1] ** 2, 1e-24))
    cos_phi_k = jnp.where(normal_incidence, 1.0, k[..., 0] * nrm)
    sin_phi_k = jnp.where(normal_incidence, 0.0, k[..., 1] * nrm)
    xslope = cos_phi_k * tx - sin_phi_k * ty
    yslope = sin_phi_k * tx + cos_phi_k * ty
    return xslope, yslope


def _sample_nmap_radial(dist, u1, u2):
    """Polar NDF sampling (reference radial::sample_vp22_std_nmap,
    dj_brdf.h:1806-1816)."""
    phi_h = u1 * 2.0 * jnp.pi
    r_h = dist.qf_radial(u2)
    return r_h * jnp.cos(phi_h), r_h * jnp.sin(phi_h)


@pytree_dataclass
class Beckmann:
    """Beckmann (Gaussian-slope) distribution (reference djb::beckmann,
    dj_brdf.h:1863-1957)."""

    supports_smith_vndf: bool = static_field(default=True)

    # -- radial queries ----------------------------------------------
    def p22_radial(self, r_sqr):
        return jnp.exp(-r_sqr) / jnp.pi

    def sigma_std_radial(self, cos_theta_k):
        """Closed-form projected area with erf (dj_brdf.h:1871-1879)."""
        c = cos_theta_k
        sin_theta_k = jnp.sqrt(jnp.maximum(1.0 - c * c, 1e-24))
        safe_sin = jnp.maximum(sin_theta_k, 1e-12)
        nu = c / safe_sin
        tmp = jnp.exp(-nu * nu) * _SQRT_PI_INV
        sigma = (c * (1.0 + erf(nu)) + sin_theta_k * tmp) / 2.0
        return jnp.where(c >= 1.0, 1.0, sigma)

    def cdf_radial(self, r):
        return 1.0 - jnp.exp(-r * r)

    def qf_radial(self, u):
        return jnp.sqrt(-jnp.log(jnp.maximum(1.0 - u, 1e-38)))

    def qf1(self, u):
        return erfinv(2.0 * u - 1.0)

    def qf2_radial(self, u, cos_theta_k, sin_theta_k):
        """Visible-slope quantile (dj_brdf.h:1897-1952); see
        :func:`beckmann_qf2_slope_domain`."""
        return beckmann_qf2_slope_domain(u, cos_theta_k, sin_theta_k)

    def qf3_radial(self, u, qf2):
        return self.qf1(u)

    # -- standard-frame interface -------------------------------------
    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])

    def sample_vp22_std(self, u1, u2, k):
        return _sample_smith_radial(self, u1, u2, k)


@pytree_dataclass
class GGX:
    """GGX / Trowbridge-Reitz distribution (reference djb::ggx,
    dj_brdf.h:2053-2146)."""

    supports_smith_vndf: bool = static_field(default=True)

    def p22_radial(self, r_sqr):
        tmp = 1.0 + r_sqr
        return 1.0 / (jnp.pi * tmp * tmp)

    def sigma_std_radial(self, cos_theta_k):
        return (1.0 + cos_theta_k) / 2.0

    def cdf_radial(self, r):
        tmp = r * r
        return tmp / (1.0 + tmp)

    def qf_radial(self, u):
        return jnp.sqrt(u / jnp.maximum(1.0 - u, 1e-12))

    def qf1(self, u):
        """Closed-form marginal slope quantile (dj_brdf.h:2078-2087)."""
        t = jnp.abs(2.0 * u - 1.0)
        mag = t * jax.lax.rsqrt(jnp.maximum(1.0 - t * t, 1e-12))
        return jnp.where(u < 0.5, -mag, mag)

    def qf2_radial(self, u, cos_theta_k, sin_theta_k):
        """Closed-form visible x-slope quantile, 4-branch tan/cot form
        made branchless (dj_brdf.h:2089-2119)."""
        sin_theta = u * (1.0 + cos_theta_k) - 1.0
        cos_theta = jnp.sqrt(jnp.maximum(1.0 - sin_theta * sin_theta, 1e-24))

        safe_cos = jnp.maximum(cos_theta, 1e-12)
        safe_sin_t = jnp.where(sin_theta == 0.0, 1e-12, sin_theta)
        tan_theta = sin_theta / safe_cos
        cot_theta = cos_theta / safe_sin_t

        safe_cos_k = jnp.maximum(cos_theta_k, 1e-12)
        safe_sin_k = jnp.maximum(sin_theta_k, 1e-12)
        tan_theta_k = sin_theta_k / safe_cos_k
        cot_theta_k = cos_theta_k / safe_sin_k

        # branch on cos_theta > sin(pi/4) and sin_theta_k < sin(pi/4)
        s = 0.707107
        r_tt = -(tan_theta + tan_theta_k) / (1.0 - tan_theta * tan_theta_k)
        r_tc = (1.0 + tan_theta * cot_theta_k) / (tan_theta - cot_theta_k)
        r_ct = (1.0 + tan_theta_k * cot_theta) / (tan_theta_k - cot_theta)
        r_cc = (cot_theta + cot_theta_k) / (1.0 - cot_theta * cot_theta_k)
        return jnp.where(cos_theta > s,
                         jnp.where(sin_theta_k < s, r_tt, r_tc),
                         jnp.where(sin_theta_k < s, r_ct, r_cc))

    def qf3_radial(self, u, qf2):
        """Sign-split rational approximation (dj_brdf.h:2121-2146,
        coefficients from Mitsuba)."""
        alpha = jnp.sqrt(1.0 + qf2 * qf2)
        s = jnp.where(u < 0.5, -1.0, 1.0)
        t = jnp.where(u < 0.5, 2.0 * (0.5 - u), 2.0 * (u - 0.5))
        p = t * (t * (t * (-0.365728915865723)
                 + 0.790235037209296) - 0.424965825137544) + 0.000152998850436920
        q = t * (t * (t * (t * 0.169507819808272 - 0.397203533833404)
                 - 0.232500544458471) + 1.0) - 0.539825872510702
        return s * alpha * (p / q)

    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])

    def sample_vp22_std(self, u1, u2, k):
        return _sample_smith_radial(self, u1, u2, k)


@pytree_dataclass
class GGXSphericalCaps(GGX):
    """GGX with spherical-cap VNDF sampling (Dupuy & Benyoub,
    "Sampling Visible GGX Normals with Spherical Caps", 2023,
    arXiv:2306.05044): samples the visible half-vector directly from a
    uniform spherical cap — 2 transcendentals instead of the
    reference's 4-branch qf2 + rational qf3 (dj_brdf.h:2089-2146).
    Identical distribution (VNDF) and pdf; strictly a faster sampler,
    not present in the reference."""

    def sample_vp22_std(self, u1, u2, k):
        kz = k[..., 2]
        phi = 2.0 * jnp.pi * u1
        # uniform z on the cap [-kz, 1]
        z = (1.0 - u2) * (1.0 + kz) - kz
        sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
        cx = sin_t * jnp.cos(phi)
        cy = sin_t * jnp.sin(phi)
        # visible half-vector (un-normalized is fine for slopes)
        hx = cx + k[..., 0]
        hy = cy + k[..., 1]
        hz = jnp.maximum(z + kz, 1e-12)
        return -hx / hz, -hy / hz


@pytree_dataclass
class Tabular:
    """Isotropic tabulated distribution (reference djb::tabular,
    dj_brdf.h:2148-2176). Tables are device arrays produced by the
    fitting pipeline (:mod:`dj_brdf_tpu.fit.tabular`) and are
    differentiable leaves.

    * ``p22``:  (res,) slope PDF sampled in u = sqrt(2 atan(r)/pi)
    * ``sigma``: (res,) projected area sampled in u = 2 theta/pi
    * ``cdf``, ``qf``: (res,) radial CDF/quantile for nmap sampling
    """

    p22: jnp.ndarray
    sigma: jnp.ndarray
    cdf: jnp.ndarray
    qf: jnp.ndarray
    supports_smith_vndf: bool = static_field(default=False)

    # NOTE on the 1e-24 floors and the atan2 arccos: sqrt/arccos have
    # infinite derivatives at 0 / +-1, and those inputs are HIT
    # EXACTLY by sanitized lanes (h = up => r_sqr = 0, i = up =>
    # cos = 1); the values are gated out of forward outputs, but a
    # 0-cotangent x inf-derivative is NaN in reverse mode, which
    # poisons per-lane texture gradients. Value changes are <= 1e-12.
    def p22_radial(self, r_sqr):
        r = jnp.sqrt(jnp.maximum(r_sqr, 1e-24))
        u = jnp.sqrt(jnp.maximum(2.0 * jnp.arctan(r) / jnp.pi, 1e-24))
        return spline.eval1d(self.p22, u, wrap="edge")

    def sigma_std_radial(self, cos_theta_k):
        c = jnp.clip(cos_theta_k, -1.0, 1.0)
        # arccos via atan2 with a floored sine: same value, finite
        # derivative at the poles
        theta = jnp.arctan2(jnp.sqrt(jnp.maximum(1.0 - c * c, 1e-24)), c)
        return spline.eval1d(self.sigma, 2.0 * theta / jnp.pi,
                             wrap="edge")

    def cdf_radial(self, r):
        u = jnp.maximum(jnp.arctan(r) * 2.0 / jnp.pi, 1e-24)
        return spline.eval1d(self.cdf, jnp.sqrt(u), wrap="edge")

    def qf_radial(self, u):
        qf = spline.eval1d(self.qf, u, wrap="edge")
        return jnp.tan(qf * jnp.pi / 2.0)

    def p22_std(self, x, y):
        return self.p22_radial(x * x + y * y)

    def sigma_std(self, k):
        return self.sigma_std_radial(k[..., 2])

    def sample_vp22_std(self, u1, u2, k):
        return _sample_nmap_radial(self, u1, u2)


@pytree_dataclass
class TabularAnisotropic:
    """Anisotropic tabulated distribution (reference
    djb::tabular_anisotropic, dj_brdf.h:2178-2211, 2766-3103).

    2D tables are stored as (azimuthal_res, elevation_res) so the
    elevation axis is the fast (lane) axis, matching the reference's
    flat ``points[i + w*j]`` layout. Sampling uses the marginal-azimuth
    / conditional-elevation factorization (pdf1/cdf1/qf1, pdf2/cdf2/qf2).
    """

    p22: jnp.ndarray     # (H=azimuthal, W=elevation)
    sigma: jnp.ndarray   # (H, W)
    pdf1: jnp.ndarray    # (H,)
    cdf1: jnp.ndarray    # (H,)
    qf1_table: jnp.ndarray  # (H,)
    pdf2: jnp.ndarray    # (H, W)
    cdf2: jnp.ndarray    # (H, W)
    qf2_table: jnp.ndarray  # (H, W)
    supports_smith_vndf: bool = static_field(default=False)

    # -- eval ----------------------------------------------------------
    def p22_std_theta_phi(self, theta, phi):
        """(dj_brdf.h:2185-2196)."""
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        u1 = theta * 2.0 / jnp.pi
        u2 = phi * 0.5 / jnp.pi
        return spline.eval2d(self.p22, u1, u2, wrap1="edge", wrap2="repeat")

    # pole/origin guards as in Tabular: sqrt/arccos/atan2 have
    # infinite or 0/0 derivatives exactly where sanitized lanes land
    # (slopes (0,0), k = up); floors keep reverse-mode finite at
    # <= 1e-12 value change
    def p22_std(self, x, y):
        r2 = x * x + y * y
        theta = jnp.arctan(jnp.sqrt(jnp.maximum(r2, 1e-24)))
        phi = jnp.arctan2(-y, jnp.where(r2 < 1e-24, -1.0, -x))
        return self.p22_std_theta_phi(theta, phi)

    def sigma_std(self, k):
        """(dj_brdf.h:2198-2211)."""
        c = jnp.clip(k[..., 2], -1.0, 1.0)
        theta = jnp.arctan2(jnp.sqrt(jnp.maximum(1.0 - c * c, 1e-24)), c)
        r2 = k[..., 0] * k[..., 0] + k[..., 1] * k[..., 1]
        phi = jnp.arctan2(k[..., 1],
                          jnp.where(r2 < 1e-24, 1.0, k[..., 0]))
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        u1 = theta * 2.0 / jnp.pi
        u2 = phi * 0.5 / jnp.pi
        return spline.eval2d(self.sigma, u1, u2, wrap1="edge", wrap2="repeat")

    # -- sampling tables ----------------------------------------------
    def pdf1_eval(self, phi):
        return spline.eval1d(self.pdf1, phi * 0.5 / jnp.pi, wrap="repeat")

    def cdf1_eval(self, phi):
        return spline.eval1d(self.cdf1, phi * 0.5 / jnp.pi, wrap="repeat")

    def qf1_eval(self, u1):
        return spline.eval1d(self.qf1_table, u1, wrap="edge") * 2.0 * jnp.pi

    def pdf2_eval(self, theta, phi):
        val = spline.eval2d(self.pdf2, theta * 2.0 / jnp.pi, phi * 0.5 / jnp.pi,
                            wrap1="edge", wrap2="repeat")
        return jnp.where(theta >= 0.5 * jnp.pi, 0.0, val)

    def cdf2_eval(self, theta, phi):
        val = spline.eval2d(self.cdf2, theta * 2.0 / jnp.pi, phi * 0.5 / jnp.pi,
                            wrap1="edge", wrap2="repeat")
        return jnp.where(theta >= 0.5 * jnp.pi, 1.0, val)

    def qf2_eval(self, u, phi):
        return spline.eval2d(self.qf2_table, u, phi / (2.0 * jnp.pi),
                             wrap1="edge", wrap2="repeat") * 0.5 * jnp.pi

    def sample_vp22_std(self, u1, u2, k):
        """Marginal/conditional nmap sampling (dj_brdf.h:2826-2837)."""
        phi = self.qf1_eval(u1)
        theta = self.qf2_eval(u2, phi)
        tan_theta = jnp.tan(theta)
        return -tan_theta * jnp.cos(phi), -tan_theta * jnp.sin(phi)
