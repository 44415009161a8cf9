"""Fit-loss forward + hand adjoint as one Pallas kernel (Triton route).

One launch fits M materials against a shared direction set: each
program loads one block of the six direction components once, keeps it
in registers, and loops over the materials inside the block, reading
only that material's three target rows (12 B/sample/material). The XLA
form of the same adjoint (``jax.vmap`` of ``soa.*_lsq_fwdbwd_soa``)
rereads the 24 B/sample of directions for every material. M = 1 is the
single-material fit.

Each (block, material) pair writes one 16-lane row [loss, grad(8), 0...];
the rows are summed outside the kernel. Gradients are w.r.t. the 8
constrained parameters [ax, ay, rho, txn, tyn, f0r, f0g, f0b]; the
chain through ``fit.lsq.raw_to_model`` happens outside.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from dj_brdf_tpu.ops.soa import beckmann_lsq_fwdbwd_soa, ggx_lsq_fwdbwd_soa

_ROW = 16  # output lanes per (block, material): 1 loss + 8 grads
_FWDBWD = {"ggx": ggx_lsq_fwdbwd_soa, "beck": beckmann_lsq_fwdbwd_soa}
# masked-off lanes read i = +z, o = -z (below the horizon) and target 0,
# which the adjoint gates to exactly zero loss and gradient
_DIR_FILL = (0.0, 0.0, 1.0, 0.0, 0.0, -1.0)


def _kernel(pvec_ref, ix, iy, iz, ox, oy, oz, tr, tg, tb, out_ref, *,
            family: str, n: int, m: int, block: int):
    g = pl.program_id(0)
    idx = g * block + jnp.arange(block)
    mask = idx < n
    dirs = tuple(plgpu.load(r.at[idx], mask=mask, other=fill)
                 for r, fill in zip((ix, iy, iz, ox, oy, oz), _DIR_FILL))
    lane = jnp.arange(_ROW)

    def material(k, carry):
        pvec = tuple(pvec_ref[k * 8 + j] for j in range(8))
        tgt = tuple(plgpu.load(t.at[k * n + idx], mask=mask, other=0.0)
                    for t in (tr, tg, tb))
        val, grad = _FWDBWD[family](pvec, *dirs, *tgt, stack=tuple)
        row = sum(jnp.where(lane == j, s, 0.0)
                  for j, s in enumerate((val, *grad)))
        plgpu.store(out_ref.at[(g * m + k) * _ROW + lane], row)
        return carry

    jax.lax.fori_loop(0, m, material, 0)


@functools.partial(jax.jit, static_argnames=("family", "block", "num_warps",
                                             "interpret"))
def lsq_value_and_grad_batched(pvecs, ix, iy, iz, ox, oy, oz, tr, tg, tb,
                               family: str = "ggx", block: int = 256,
                               num_warps: int = 4, interpret: bool = False):
    """Per-material ``(loss_sum (M,), grad_sum (M, 8))`` of the
    relative-L2 microfacet + Schlick fit (``family`` "ggx" or "beck").

    ``pvecs``: (M, 8) constrained parameter rows. Directions ix..oz:
    flat (N,), shared by all materials. Targets tr/tg/tb: (M, N). Any N
    works: the last block is masked. Sums, not means: divide by N (and
    the gradient by M for a mean over materials) outside.

    ``block`` samples per program and ``num_warps`` default to the
    fastest of (256, 4), (512, 4), (1024, 8) on an H100 at 2^23
    samples and at 16 and 100 materials x 2^20 (PERF.md)."""
    m, n = tr.shape
    grid = pl.cdiv(n, block)
    kernel = functools.partial(_kernel, family=family, n=n, m=m,
                               block=block)
    rows = pl.pallas_call(
        kernel,
        grid=(grid,),
        out_shape=jax.ShapeDtypeStruct((grid * m * _ROW,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"{family}_lsq_fwdbwd",
    )(pvecs.reshape(-1), ix, iy, iz, ox, oy, oz,
      tr.reshape(-1), tg.reshape(-1), tb.reshape(-1))
    sums = rows.reshape(grid, m, _ROW).sum(axis=0)
    return sums[:, 0], sums[:, 1:9]
