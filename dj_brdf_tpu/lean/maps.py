"""Displacement/normal/LEAN map construction as batched image ops.

JAX versions of the reference's CLI map builders:
``utils/dmap2nmap.cpp`` (central-difference normals, :13-44),
``utils/nmap2leanmap.cpp`` (slope moments + base roughness, :18-54) and
``utils/nmap2leanmap_biased.cpp`` (the +25/+625 bias for unsigned
texture formats, :20-63), plus the mip-pyramid reduction that is the
point of LEAN mapping: averaging the five moments (a 2x2 mean per
level — the reference leaves this to the renderer's mip machinery;
here it is an explicit jnp tree reduction).

Images are float arrays in [0, 1] (or raw moments); the uint8
quantization of the reference tools lives in the CLI wrappers so the
core stays differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

from dj_brdf_tpu.lean.lrep import Lrep

#: Bias added by nmap2leanmap_biased so EXR-less pipelines can store
#: negative first moments in unsigned textures (nmap2leanmap_biased.cpp:40-48).
LEAN_BIAS = 25.0


def _shift(img, dx: int, dy: int, clamp_to_border: bool):
    """Neighbour fetch with repeat (default) or edge-clamp semantics,
    matching CImg's sampler setup in dmap2nmap.cpp:93-100."""
    if clamp_to_border:
        pad_x = jnp.clip(jnp.arange(img.shape[1]) + dx, 0, img.shape[1] - 1)
        pad_y = jnp.clip(jnp.arange(img.shape[0]) + dy, 0, img.shape[0] - 1)
    else:
        pad_x = jnp.mod(jnp.arange(img.shape[1]) + dx, img.shape[1])
        pad_y = jnp.mod(jnp.arange(img.shape[0]) + dy, img.shape[0])
    return img[pad_y][:, pad_x]


def dmap_to_nmap(dmap, scale: float = 0.01, clamp_to_border: bool = False):
    """Displacement map (H, W) in [0,1] -> unit normal map (H, W, 3)
    (reference dmap2nmap, utils/dmap2nmap.cpp:13-44)."""
    h, w = dmap.shape
    z_l = _shift(dmap, -1, 0, clamp_to_border)
    z_r = _shift(dmap, +1, 0, clamp_to_border)
    z_b = _shift(dmap, 0, +1, clamp_to_border)
    z_t = _shift(dmap, 0, -1, clamp_to_border)
    slope_x = w * 0.5 * scale * (z_r - z_l)
    slope_y = h * 0.5 * scale * (z_t - z_b)
    nrm_inv = 1.0 / jnp.sqrt(1.0 + slope_x ** 2 + slope_y ** 2)
    return jnp.stack([-slope_x * nrm_inv, -slope_y * nrm_inv, nrm_inv],
                     axis=-1)


def nmap_to_lean(nmap, base_roughness: float = 1e-5, bias: float = 0.0) -> Lrep:
    """Normal map (H, W, 3) -> per-texel LEAN moments (reference
    nmap2leanmap, utils/nmap2leanmap.cpp:18-54; pass ``bias=LEAN_BIAS``
    for the biased variant, nmap2leanmap_biased.cpp:40-48)."""
    nz = jnp.maximum(nmap[..., 2], 1e-6)
    slope_x = -nmap[..., 0] / nz
    slope_y = -nmap[..., 1] / nz
    br2 = 0.5 * base_roughness * base_roughness
    return Lrep(E1=slope_x + bias,
                E2=slope_y + bias,
                E3=slope_x * slope_x + br2,
                E4=slope_y * slope_y + br2,
                E5=slope_x * slope_y + bias * bias)


def unbias(lean: Lrep, bias: float = LEAN_BIAS) -> Lrep:
    """Remove the storage bias at fetch time (the renderer side,
    mitsuba/dj_beckmannconductor.cpp:300-303: E1-=25, E2-=25,
    E5-=625)."""
    return Lrep(E1=lean.E1 - bias, E2=lean.E2 - bias,
                E3=lean.E3, E4=lean.E4, E5=lean.E5 - bias * bias)


def mip_reduce(lean: Lrep) -> Lrep:
    """One mip level: 2x2 mean of each moment plane (the LEAN filter —
    averaging moments is exact for the mixture of texel NDFs)."""
    def pool(x):
        h, w = x.shape[-2:]
        x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
        return x.mean(axis=(-3, -1))
    return Lrep(E1=pool(lean.E1), E2=pool(lean.E2), E3=pool(lean.E3),
                E4=pool(lean.E4), E5=pool(lean.E5))


def build_mip_pyramid(lean: Lrep) -> list[Lrep]:
    """Pyramid of 2x2 moment means; levels[0] is the input. Stops at
    1x1 — or earlier when a dimension turns odd, since
    :func:`mip_reduce`'s 2x2 pooling needs even extents (power-of-two
    maps get the full chain)."""
    levels = [lean]
    while (levels[-1].E1.shape[-1] > 1 and levels[-1].E1.shape[-2] > 1
           and levels[-1].E1.shape[-1] % 2 == 0
           and levels[-1].E1.shape[-2] % 2 == 0):
        levels.append(mip_reduce(levels[-1]))
    return levels
