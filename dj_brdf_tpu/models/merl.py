"""MERL measured-BRDF evaluation.

JAX version of ``djb::merl`` (dj_brdf.h:870-1024): the
90x90x180x3 table lives in device memory as one f32 array (~17.5 MB, replicated
per device — never sharded); evaluation is a fused angle transform
(Rusinkiewicz io->hd in closed component form — no Rodrigues
rotations), the three MERL index warps (non-linear sqrt theta_h bin,
reciprocity-folded phi_d), and ONE channel-interleaved row gather.

Layout notes (docs/DESIGN.md "Measured-table gathers"):

* The table must reach the jitted program as an *argument* (a pytree
  leaf), never as a jit closure constant: XLA embeds closure arrays as
  program literals, which inflates compile time and takes a slower
  gather path.
* One gather of a (1, 3) channel-interleaved row per sample issues one
  index for all three channels instead of three scalar gathers.

Lookup is nearest-neighbour, exactly like the reference — gradients
w.r.t. directions are therefore zero a.e.; the *table* is the
differentiable leaf (e.g. for fitting or neural re-parameterization).

Binary file I/O lives in :mod:`dj_brdf_tpu.io.merl_io`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dj_brdf_tpu.core.pytree import pytree_dataclass, static_field

RES_THETA_H = 90
RES_THETA_D = 90
RES_PHI_D = 360  # table stores RES_PHI_D / 2 = 180 bins (reciprocity)

#: Per-channel radiometric scales (dj_brdf.h:897-899).
RED_SCALE = 1.00 / 1500.0
GREEN_SCALE = 1.15 / 1500.0
BLUE_SCALE = 1.66 / 1500.0


def theta_half_index(theta_half):
    """Non-linear sqrt-warped theta_h bin (dj_brdf.h:906-920)."""
    theta_half_deg = theta_half / (jnp.pi / 2.0) * RES_THETA_H
    temp = jnp.sqrt(jnp.maximum(theta_half_deg * RES_THETA_H, 0.0))
    idx = jnp.floor(temp).astype(jnp.int32)
    idx = jnp.clip(idx, 0, RES_THETA_H - 1)
    return jnp.where(theta_half <= 0.0, 0, idx)


def theta_diff_index(theta_diff):
    """(dj_brdf.h:926-936)."""
    idx = jnp.floor(theta_diff / (jnp.pi * 0.5) * RES_THETA_D).astype(jnp.int32)
    return jnp.clip(idx, 0, RES_THETA_D - 1)


def phi_diff_index(phi_diff):
    """Reciprocity fold phi_d -> phi_d + pi for negative phi_d
    (dj_brdf.h:940-957)."""
    phi_diff = jnp.where(phi_diff < 0.0, phi_diff + jnp.pi, phi_diff)
    idx = jnp.floor(phi_diff / jnp.pi * (RES_PHI_D // 2)).astype(jnp.int32)
    return jnp.clip(idx, 0, RES_PHI_D // 2 - 1)


def hd_angles(i, o):
    """(theta_h, theta_d, phi_d) of the Rusinkiewicz transform in
    closed component form: the two axis rotations of brdf::io_to_hd
    (dj_brdf.h:771-781) collapse to arithmetic on the components of h
    (cos(phi_h) = h.x/rho etc.), so only the three output angles cost
    a transcendental. Matches to_spherical's pole clamps
    (dj_brdf.h:650-661)."""
    h = i + o
    h = h * jax.lax.rsqrt(jnp.maximum(jnp.sum(h * h, axis=-1), 1e-24))[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    rho = jnp.sqrt(jnp.maximum(hx * hx + hy * hy, 0.0))
    # at the pole the reference uses phi_h = 0 (to_spherical clamp)
    at_pole = hz > 0.99999
    inv_rho = jnp.where(rho > 0.0, 1.0 / jnp.maximum(rho, 1e-24), 1.0)
    cos_ph = jnp.where(at_pole, 1.0, hx * inv_rho)
    sin_ph = jnp.where(at_pole, 0.0, hy * inv_rho)
    sin_th = jnp.where(at_pole, 0.0, rho)
    cos_th = jnp.where(at_pole, 1.0, hz)

    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    t = cos_ph * ix + sin_ph * iy
    dx = cos_th * t - sin_th * iz
    dy = -sin_ph * ix + cos_ph * iy
    dz = sin_th * t + cos_th * iz
    # io_to_hd normalizes d (rotation of a unit vector: renormalize
    # only against rounding drift)
    dn = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-24))
    dx, dy, dz = dx * dn, dy * dn, dz * dn

    theta_h = jnp.where(at_pole, 0.0,
                        jnp.arccos(jnp.clip(hz, -1.0, 1.0)))
    d_pole = dz > 0.99999
    theta_d = jnp.where(d_pole, 0.0, jnp.arccos(jnp.clip(dz, -1.0, 1.0)))
    phi_d = jnp.where(d_pole, 0.0, jnp.arctan2(dy, dx))
    return theta_h, theta_d, phi_d


def merl_flat_index(i, o):
    """Fused angle transform + the three MERL bin warps -> flat index
    into a (90*90*180,) channel plane (dj_brdf.h:906-957, 987-1006)."""
    theta_h, theta_d, phi_d = hd_angles(i, o)
    ih = theta_half_index(theta_h)
    id_ = theta_diff_index(theta_d)
    ip = phi_diff_index(phi_d)
    return (ih * RES_THETA_D + id_) * (RES_PHI_D // 2) + ip


_SCALES = (RED_SCALE, GREEN_SCALE, BLUE_SCALE)


def _debug_below_horizon(mask) -> None:
    """DJB_LOG parity with merl::eval's per-eval "below horizon"
    warning (dj_brdf.h:1016-1021), aggregated to a count per eval
    batch. Gated at TRACE time on the logger's DEBUG level so the
    default path adds zero device work (like the reference's NVERBOSE
    compile flag); toggling the level needs `jax.clear_caches()` to
    take effect on already-jitted programs."""
    import logging

    from dj_brdf_tpu.config import logger
    if not logger.isEnabledFor(logging.DEBUG):
        return

    def log(count):
        if int(count) > 0:
            logger.debug("merl eval: %d below-horizon lookups set to 0",
                         int(count))

    jax.debug.callback(log, jnp.sum(mask))


@pytree_dataclass
class Merl:
    """MERL table BRDF. ``table``: (3, 90, 90, 180) raw (unscaled)
    samples, channel-major like the binary file.

    Pass instances *into* jitted functions (they are pytrees); do not
    close over them — a closure-captured table becomes an XLA program
    constant and hits a ~600x slower gather path (see module docs).
    """

    table: jnp.ndarray

    def eval(self, i, o):
        """f_r lookup (reference merl::eval, dj_brdf.h:987-1024).
        Returns (..., 3); negative raw entries (below-horizon) map to 0.

        One channel-interleaved row gather per sample: the (N, 3) row
        fetch issues one index for three channels. The in-program
        transpose of the table is a single streaming pass, amortized
        across the gather."""
        idx = merl_flat_index(i, o)
        inter = jnp.transpose(self.table.reshape(3, -1), (1, 0))  # (n, 3)
        # indices are clipped in-range by the bin warps -> 'clip' mode
        # keeps XLA on the fast gather path ('fill' adds an OOB select)
        rgb = jnp.take(inter, idx, axis=0, mode="clip")
        rgb = rgb * jnp.asarray(_SCALES, rgb.dtype)
        below_horizon = jnp.any(rgb < 0.0, axis=-1, keepdims=True)
        _debug_below_horizon(below_horizon)
        return jnp.where(below_horizon, 0.0, rgb)

    def evalp(self, i, o):
        return self.eval(i, o) * i[..., 2:3]
