"""Vector math on ``(..., 3)`` arrays.

JAX counterpart of the reference's scalar ``vec3`` utilities
(dj_brdf.h:570-766): everything here is branchless, broadcasts over
leading batch dimensions, and is differentiable. There is no vector
class — a direction is just the last axis of a jnp array, so ``vmap``
replaces per-sample loops and XLA fuses the arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Rec.709 luma weights (reference vec3::intensity, dj_brdf.h:69).
_LUMA = (0.2126, 0.7152, 0.0722)


def vec3(x, y, z):
    """Stack components into a (..., 3) array."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype=jnp.result_type(float, x, y, z)),
        jnp.asarray(y, dtype=jnp.result_type(float, x, y, z)),
        jnp.asarray(z, dtype=jnp.result_type(float, x, y, z))), axis=-1)


def from_spherical(theta, phi):
    """Direction from spherical angles (reference vec3(theta,phi) ctor,
    dj_brdf.h:589-595)."""
    s = jnp.sin(theta)
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), jnp.cos(theta) * jnp.ones_like(phi))


def to_spherical(p):
    """(theta, phi) from a direction, with pole clamps matching
    xyz_to_theta_phi (dj_brdf.h:650-661)."""
    z = p[..., 2]
    near_np = z > 0.99999
    near_sp = z < -0.99999
    theta = jnp.where(near_np, 0.0, jnp.where(near_sp, jnp.pi,
                      jnp.arccos(jnp.clip(z, -1.0, 1.0))))
    phi = jnp.where(near_np | near_sp, 0.0, jnp.arctan2(p[..., 1], p[..., 0]))
    return theta, phi


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def normalize(v, eps: float = 0.0):
    """Unit vector; safe under grad (no 0/0 when eps>0)."""
    mag_sqr = dot(v, v)
    if eps:
        mag_sqr = jnp.maximum(mag_sqr, eps)
    return v * jax.lax.rsqrt(mag_sqr)[..., None]


def intensity(rgb):
    """Rec.709 luma (reference vec3::intensity, dj_brdf.h:69)."""
    w = jnp.asarray(_LUMA, dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def sat(x):
    """Saturate to [0, 1] (reference sat, dj_brdf.h:576)."""
    return jnp.clip(x, 0.0, 1.0)


def rotate_vector(x, axis, angle):
    """Rodrigues axis-angle rotation (reference rotate_vector,
    dj_brdf.h:754-765). ``axis`` must be unit length."""
    angle = jnp.asarray(angle)
    c = jnp.cos(angle)[..., None]
    s = jnp.sin(angle)[..., None]
    return x * c + axis * (dot(axis, x) * (1.0 - jnp.squeeze(c, -1)))[..., None] \
        + cross(axis, x) * s


def io_to_hd(i, o):
    """(i, o) -> (h, d) Rusinkiewicz transform (reference brdf::io_to_hd,
    dj_brdf.h:771-781): h = normalize(i+o); d = i rotated into the frame
    where h is the pole."""
    h = normalize(i + o)
    theta_h, phi_h = to_spherical(h)
    z_axis = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], i.dtype), i.shape)
    y_axis = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], i.dtype), i.shape)
    tmp = rotate_vector(i, z_axis, -phi_h)
    d = normalize(rotate_vector(tmp, y_axis, -theta_h))
    return h, d


def hd_to_io(h, d):
    """(h, d) -> (i, o) inverse Rusinkiewicz transform (reference
    brdf::hd_to_io, dj_brdf.h:783-793)."""
    theta_h, phi_h = to_spherical(h)
    z_axis = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], h.dtype), h.shape)
    y_axis = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], h.dtype), h.shape)
    tmp = rotate_vector(d, y_axis, theta_h)
    i = normalize(rotate_vector(tmp, z_axis, phi_h))
    o = normalize(2.0 * dot(i, h)[..., None] * h - i)
    return i, o


def reflect(o, h):
    """Mirror o about h."""
    return 2.0 * dot(o, h)[..., None] * h - o


def uniform_to_concentric(u1, u2):
    """Square -> disk concentric map, branchless (reference
    uniform_to_concentric, dj_brdf.h:726-747, after Dave Cline)."""
    r1 = 2.0 * u1 - 1.0
    r2 = 2.0 * u2 - 1.0
    use_r1 = r1 * r1 > r2 * r2
    r = jnp.where(use_r1, r1, r2)
    # guard divisions at the origin
    safe_r1 = jnp.where(r1 == 0.0, 1.0, r1)
    safe_r2 = jnp.where(r2 == 0.0, 1.0, r2)
    phi = jnp.where(use_r1,
                    (jnp.pi / 4.0) * (r2 / safe_r1),
                    (jnp.pi / 2.0) - (r1 / safe_r2) * (jnp.pi / 4.0))
    degenerate = (r1 == 0.0) & (r2 == 0.0)
    r = jnp.where(degenerate, 0.0, r)
    phi = jnp.where(degenerate, 0.0, phi)
    return r * jnp.cos(phi), r * jnp.sin(phi)


def cosine_hemisphere_sample(u1, u2):
    """Cosine-weighted hemisphere direction via the concentric map
    (reference brdf::sample default, dj_brdf.h:830-840)."""
    x, y = uniform_to_concentric(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return vec3(x, y, z)
