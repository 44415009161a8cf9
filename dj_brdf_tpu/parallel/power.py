"""Row-sharded power iteration for the anisotropic kernel matrix.

The reference's anisotropic NDF extraction multiplies a dense
(w*h)^2 matrix — 8010^2 ~ 64 M entries at the 90x90 production
resolution — four times from an all-ones start (dj_brdf.h:2525-2579,
2467-2480). Here each mesh shard *builds its own row block on the fly*
(never materializing more than n/D rows per device), computes its
local matvec partial, and the full iterate is reassembled with an
all-gather between devices — the framework's one TP-style pattern.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.parallel.mesh import DATA_AXIS


def _aniso_row_terms(row_idx, elevation_res: int, azimuthal_res: int):
    """Per-row factors of the anisotropic kernel (dj_brdf.h:2550-2565):
    slopes and tan/cos^2 weight at the row's (theta, phi)."""
    w = elevation_res - 1
    j1 = (row_idx % w).astype(jnp.float32)
    j2 = (row_idx // w).astype(jnp.float32)
    theta = j1 / w * jnp.float32(0.5 * np.pi)
    phi = j2 / azimuthal_res * jnp.float32(2.0 * np.pi)
    tan_t = jnp.tan(theta)
    cos_t = jnp.cos(theta)
    slope1 = -tan_t * jnp.cos(phi)
    slope2 = -tan_t * jnp.sin(phi)
    weight = tan_t / (cos_t * cos_t)
    return slope1, slope2, weight


def _aniso_col_terms(eval_fn, elevation_res: int, azimuthal_res: int):
    """Per-column factors (dj_brdf.h:2536-2548): retro-reflective BRDF
    intensity and direction components at each column's (theta, phi)."""
    w = elevation_res - 1
    h = azimuthal_res
    dtheta = np.sqrt(np.pi * 0.5) / w
    dphi = 2.0 * np.pi / h
    col = jnp.arange(w * h)
    i1 = (col % w).astype(jnp.float32)
    i2 = (col // w).astype(jnp.float32)
    theta = i1 / w * jnp.float32(0.5 * np.pi)
    phi = i2 / h * jnp.float32(2.0 * np.pi)
    sin_t = jnp.sin(theta)
    zo = jnp.cos(theta)
    xo = sin_t * jnp.cos(phi)
    yo = sin_t * jnp.sin(phi)
    d = from_spherical(theta, phi)
    fr_i = jnp.einsum("nc,c->n", eval_fn(d, d),
                      jnp.asarray([0.2126, 0.7152, 0.0722], jnp.float32))
    kji_tmp1 = jnp.float32(dtheta * dphi) * (4.0 * fr_i * zo ** 5)
    return xo, yo, zo, kji_tmp1


def aniso_p22_sharded(brdf, elevation_res: int, azimuthal_res: int,
                      mesh, iterations: int = 4) -> jnp.ndarray:
    """Power-iterate the anisotropic kernel with row blocks built
    per-shard. ``brdf`` is a model pytree with ``.eval`` or a bare
    eval_fn. Returns the raw (azimuthal_res, elevation_res) p22
    table (pre-normalization), float32.

    Note the matvec orientation: ``matrix::transform`` computes
    out[col] = sum_row K(row, col) v[row], so the "rows" sharded here
    are the *columns* of K — each shard owns a block of output entries
    and reads the full v (dj_brdf.h:2456-2465)."""
    from dj_brdf_tpu.fit.tabular import as_model_eval
    eval_mod, model = as_model_eval(brdf)
    eval_fn = lambda i, o: eval_mod(model, i, o)

    w = elevation_res - 1
    h = azimuthal_res
    n = w * h
    n_dev = mesh.devices.size
    # pad the *column* (output-entry) space to a device multiple: a
    # padded column has kji_tmp1 = 0, so its kernel column — and thus
    # its output entry — is identically zero and is sliced away from
    # the gathered iterate before the next matvec
    n_pad = ((n + n_dev - 1) // n_dev) * n_dev

    xo, yo, zo, kji_tmp1 = _aniso_col_terms(eval_fn, elevation_res,
                                            azimuthal_res)

    def pad(a):
        return jnp.concatenate([a, jnp.zeros((n_pad - n,), a.dtype)])

    xo, yo, zo, kji_tmp1 = pad(xo), pad(yo), pad(zo), pad(kji_tmp1)

    def block_fn(xo_b, yo_b, zo_b, k1_b):
        # this shard owns a block of output entries (columns of K);
        # kernel entries K(row, col) for all rows x my columns
        row_idx = jnp.arange(n)
        s1, s2, wgt = _aniso_row_terms(row_idx, elevation_res, azimuthal_res)

        # K[row, col] = k1[col] * wgt[row] * max(0, zo[col]
        #               - xo[col]*s1[row] - yo[col]*s2[row])
        m_dot_o = (zo_b[None, :] - s1[:, None] * xo_b[None, :]
                   - s2[:, None] * yo_b[None, :])
        K_blk = (k1_b[None, :] * wgt[:, None]
                 * jnp.maximum(0.0, m_dot_o))          # (n, n_pad/D)

        # true f32 products (no TF32): the oracle parity of the p22
        # table rests on f32 matvec error
        hi = jax.lax.Precision.HIGHEST
        v = jnp.ones((n,), jnp.float32)
        partial = jnp.matmul(v, K_blk, precision=hi)
        for _ in range(iterations - 1):
            v = jax.lax.all_gather(partial, DATA_AXIS, tiled=True)[:n]
            partial = jnp.matmul(v, K_blk, precision=hi)  # my outputs
        return partial

    fn = jax.jit(shard_map(
        block_fn, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS)))
    v = fn(xo, yo, zo, kji_tmp1)[:n]
    grid = v.reshape(h, w)
    return jnp.concatenate([grid, jnp.zeros((h, 1), jnp.float32)], axis=1)
