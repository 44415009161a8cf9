"""UTIA measured-BRDF evaluation.

JAX version of ``djb::utia`` (dj_brdf.h:1026-1177, after Jiri
Filip's implementation): a (3, 6, 48, 6, 48) table evaluated with
quadrilinear interpolation in *degree* space over
(theta_i, phi_i, theta_v, phi_v), followed by the per-channel
sRGB-like decode and the x100 radiometric scale. The 16-tap gather +
weights is fully differentiable w.r.t. both directions and the table.

Layout (docs/DESIGN.md "Measured-table gathers"): the 16 taps x 3
channels of the naive formulation are 48 scalar gathers per sample.
Instead the loader pre-expands the table into a *corner-packed* layout
``packed[(ti,pi,tv,pv), 16*3]`` holding each cell's full 2x2x2x2
interpolation neighbourhood contiguously (11 MB, phi axes wrapped,
theta axes need no clamp since i0 <= n-2): evaluation is then ONE
192-byte row gather per sample plus a 16-tap weighted reduction in
registers. Tables are always passed as jit arguments (pytree leaves),
never closed over (closure constants take a slower XLA gather path).

The load-time clamp-negatives and the 1/140 magic scale
(dj_brdf.h:1162-1177) are applied by the loader
(:mod:`dj_brdf_tpu.io.utia_io`), matching ``utia::normalize``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dj_brdf_tpu.core.pytree import pytree_dataclass

STEP_T = 15.0
STEP_P = 7.5
NTI = 6
NPI = 48
NTV = 6
NPV = 48


def _axis_theta(theta_deg, n):
    """Edge-clamped linear bin + extrapolating weights (dj_brdf.h:1082-1111)."""
    i0 = jnp.floor(theta_deg / STEP_T).astype(jnp.int32)
    i0 = jnp.minimum(i0, n - 2)
    i1 = i0 + 1
    w1 = theta_deg - STEP_T * i0
    w0 = STEP_T * i1 - theta_deg
    s = w0 + w1
    return i0, i1, w0 / s, w1 / s


def _axis_phi(phi_deg, n):
    """Periodic azimuth bin: weights use the unwrapped upper index
    (dj_brdf.h:1095-1127)."""
    i0 = jnp.floor(phi_deg / STEP_P).astype(jnp.int32)
    i1 = i0 + 1
    w1 = phi_deg - STEP_P * i0
    w0 = STEP_P * i1 - phi_deg
    s = w0 + w1
    i1 = jnp.where(i1 == n, 0, i1)
    i0 = jnp.clip(i0, 0, n - 1)
    return i0, i1, w0 / s, w1 / s


def pack_corners(table):
    """(3, 6, 48, 6, 48) -> corner-packed (5*48*5*48, 16*3).

    Row r = ((ti0*48 + pi0)*5 + tv0)*48 + pv0 holds the 2x2x2x2 tap
    neighbourhood of base cell (ti0, pi0, tv0, pv0): tap
    k = ((dti*2 + dpi)*2 + dtv)*2 + dpv at channels [3k, 3k+3). Phi
    axes wrap (i1 = 0 after the last bin, dj_brdf.h:1123); theta axes
    need no wrap because the bin clamp keeps i0 <= n-2."""
    x = jnp.moveaxis(jnp.asarray(table), 0, -1)          # (6,48,6,48,3)
    x = jnp.stack([x, jnp.roll(x, -1, axis=3)], -1)      # ... dpv
    x = jnp.stack([x[:, :, : NTV - 1], x[:, :, 1:NTV]], -1)   # ... dtv
    x = jnp.stack([x, jnp.roll(x, -1, axis=1)], -1)      # ... dpi
    x = jnp.stack([x[: NTI - 1], x[1:NTI]], -1)          # ... dti
    # (5,48,5,48, 3, dpv, dtv, dpi, dti) -> (5,48,5,48, dti,dpi,dtv,dpv, 3)
    x = jnp.transpose(x, (0, 1, 2, 3, 8, 7, 6, 5, 4))
    return x.reshape((NTI - 1) * NPI * (NTV - 1) * NPV, 16 * 3)


def _angles_deg(i, o):
    r2d = 180.0 / jnp.pi
    theta_i = r2d * jnp.arccos(jnp.clip(i[..., 2], -1.0, 1.0))
    theta_o = r2d * jnp.arccos(jnp.clip(o[..., 2], -1.0, 1.0))
    phi_i = jnp.mod(r2d * jnp.arctan2(i[..., 1], i[..., 0]), 360.0)
    phi_o = jnp.mod(r2d * jnp.arctan2(o[..., 1], o[..., 0]), 360.0)
    return theta_i, theta_o, phi_i, phi_o


def _decode(rgb, below):
    """Per-channel sRGB-like decode + x100 scale (dj_brdf.h:1146-1150)."""
    decoded = jnp.where(rgb > 0.0375,
                        jnp.power(jnp.maximum(rgb + 0.055, 0.0) / 1.055, 2.4),
                        rgb / 12.92) * 100.0
    decoded = jnp.maximum(decoded, 0.0)
    return jnp.where(below[..., None], 0.0, decoded)


@pytree_dataclass
class Utia:
    """UTIA table BRDF. ``table``: (3, NTI, NPI, NTV, NPV) after the
    loader's clamp + 1/140 normalization. ``packed``: optional
    corner-packed layout from :func:`pack_corners`; built on the fly
    when absent (construct via :meth:`build` to amortize it).

    Pass instances *into* jitted functions (pytrees); do not close
    over them (closure tables hit XLA's slow constant-gather path)."""

    table: jnp.ndarray
    packed: jnp.ndarray | None = None

    @classmethod
    def build(cls, table):
        """Construct with the packed fast-eval layout precomputed."""
        table = jnp.asarray(table)
        return cls(table=table, packed=pack_corners(table))

    def eval(self, i, o):
        """f_r (reference utia::eval, dj_brdf.h:1063-1157). Returns (..., 3)."""
        theta_i, theta_o, phi_i, phi_o = _angles_deg(i, o)

        below = (theta_i >= 90.0) | (theta_o >= 90.0)
        # clamp angles fed to the interpolator so gathers stay in range;
        # the result is masked out anyway when below the horizon
        theta_i = jnp.minimum(theta_i, 90.0)
        theta_o = jnp.minimum(theta_o, 90.0)

        iti0, _, wti0, wti1 = _axis_theta(theta_i, NTI)
        itv0, _, wtv0, wtv1 = _axis_theta(theta_o, NTV)
        ipi0, _, wpi0, wpi1 = _axis_phi(phi_i, NPI)
        ipv0, _, wpv0, wpv1 = _axis_phi(phi_o, NPV)

        packed = self.packed if self.packed is not None \
            else pack_corners(self.table)
        row = ((iti0 * NPI + ipi0) * (NTV - 1) + itv0) * NPV + ipv0
        taps = jnp.take(packed, row, axis=0, mode="clip")  # (..., 48)
        taps = taps.reshape(*taps.shape[:-1], 16, 3)

        # weight order matches pack_corners: k = ((dti*2+dpi)*2+dtv)*2+dpv
        wt = jnp.stack([wti0, wti1], -1)                       # (..., 2)
        wp = jnp.stack([wpi0, wpi1], -1)
        wv = jnp.stack([wtv0, wtv1], -1)
        wq = jnp.stack([wpv0, wpv1], -1)
        w = (wt[..., :, None, None, None] * wp[..., None, :, None, None]
             * wv[..., None, None, :, None] * wq[..., None, None, None, :])
        w = w.reshape(*w.shape[:-4], 16)
        # HIGHEST: true f32 taps (no TF32), as the oracle parity needs
        rgb = jnp.einsum("...k,...kc->...c", w, taps,
                         precision=jax.lax.Precision.HIGHEST)
        return _decode(rgb, below)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
