"""Differentiable sphere shading — the renderer integration layer.

The reference exposes its BRDFs to a renderer through six Mitsuba BSDF
plugins (mitsuba/*.cpp); the JAX equivalent is a small JAX
renderer: a directly lit sphere (the classic BRDF "matpreview" ball)
rendered as one fused program, differentiable end-to-end so pixel
gradients flow into BRDF parameters (BASELINE.json configs 3-5).

Directions follow the local-shading-frame convention of the library:
per pixel we build the tangent frame of the sphere normal and express
the world light/view directions in it, mirroring how Mitsuba's
``its.toLocal`` feeds the plugins (mitsuba/dj_brdf.cpp:342-367).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dj_brdf_tpu.core.math import dot, normalize, vec3


def sphere_normals(res: int, dtype=jnp.float32):
    """Orthographic unit-sphere normals on a res x res pixel grid.
    Returns (normals (res,res,3), mask (res,res))."""
    xs = (jnp.arange(res, dtype=dtype) + 0.5) / res * 2.0 - 1.0
    X, Y = jnp.meshgrid(xs, -xs)  # image-space y down
    r2 = X * X + Y * Y
    inside = r2 < 1.0
    Z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    n = jnp.stack([X, Y, jnp.where(inside, Z, 1.0)], axis=-1)
    return normalize(n), inside


def _build_frame(n):
    """Tangent frame per normal (branchless Duff et al. style)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0])
    bt = vec3(b, s + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return t, bt


def world_to_local(n, v):
    """Express world direction v in the tangent frame of n."""
    t, bt = _build_frame(n)
    return vec3(dot(v, t), dot(v, bt), dot(v, n))


def sphere_uv(n):
    """Spherical UVs of unit normals: u = phi/2pi in [0,1), v = theta/pi.
    Used to map textures (roughness, LEAN moments) onto the preview
    sphere, the role Mitsuba's uv/dudx footprints play for the textured
    plugins (mitsuba/dj_beckmannconductor.cpp:285-297)."""
    theta = jnp.arccos(jnp.clip(n[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(n[..., 1], n[..., 0])
    u = jnp.mod(phi / (2.0 * jnp.pi), 1.0)
    return u, theta / jnp.pi


def sample_texture(tex, u, v):
    """Nearest-texel lookup of an (H, W, ...) texture at normalized uv
    (differentiable w.r.t. the texels)."""
    h, w = tex.shape[0], tex.shape[1]
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    return tex[yi, xi]


def render_sphere(evalp_fn, light_dir, res: int = 256,
                  light_radiance=(1.0, 1.0, 1.0), view_dir=(0.0, 0.0, 1.0)):
    """Shade a directly lit sphere.

    ``evalp_fn(i, o) -> (..., 3)`` is any BRDF's f_r*cos in the local
    frame (e.g. ``partial(mf.evalp, dist, fres, params)`` or
    ``Merl(...).evalp``). Returns an (res, res, 3) HDR image.
    Differentiable w.r.t. anything captured by ``evalp_fn`` and the
    light direction."""
    n, mask = sphere_normals(res)
    l = normalize(jnp.asarray(light_dir, jnp.float32))
    v = normalize(jnp.asarray(view_dir, jnp.float32))
    i = world_to_local(n, jnp.broadcast_to(l, n.shape))
    o = world_to_local(n, jnp.broadcast_to(v, n.shape))
    img = evalp_fn(i, o) * jnp.asarray(light_radiance, jnp.float32)
    visible = mask & (i[..., 2] > 0.0) & (o[..., 2] > 0.0)
    return jnp.where(visible[..., None], img, 0.0)
