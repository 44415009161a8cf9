"""Environment-map (image-based) lighting for the path tracer.

The reference's Mitsuba scenes (the matpreview setup its LEAN maps
ship for, mitsuba/README:21-23) are lit by lat-long environment
emitters; Mitsuba importance-samples the emitter image and combines
emitter and BSDF sampling with multiple importance sampling. This
module is the JAX equivalent, built for production-resolution
maps (1024x2048 and up):

* **O(1) alias-table sampling** (Walker/Vose): one draw costs ONE
  gather of a 4-wide alias row — no CDF searches, no O(H+W) compare
  tensors, memory per ray is O(1) at any map resolution. The table is
  built once on the host at scene load (native C, ~0.1 s for 2M bins;
  Mitsuba likewise builds its emitter CDFs host-side at scene load).
* **One-gather radiance+pdf queries**: radiance toward a direction is
  one row gather from a corner-packed (H*W, 16) layout — 4 bilinear
  corner texels plus their 4 pdf bins — so an eval-with-pdf (the MIS
  path) is a single issued gather.
* **Orientation**: an optional ``rot`` (3x3 to-world rotation) matches
  the reference scenes' emitter transforms; directions rotate in
  sample/eval, tables stay in the emitter's local frame.

Conventions: row j covers theta in [j, j+1] * pi/H (z-up; theta=0 is
+z), column i covers phi in [i, i+1] * 2pi/W, dir = (sin t cos p,
sin t sin p, cos t). The sampler is exact for its own piecewise-
constant density: pdf values are the true sampling density over solid
angle (bin mass / (bin angle area * sin theta)), so dividing by them
is unbiased and MIS weights can use them directly.

Differentiation: ``build`` runs on the host (concrete arrays only —
alias construction is inherently sequential). For inverse lighting,
:meth:`EnvMap.rebind` swaps in a differentiable radiance under the
FROZEN sampling structure — the standard detached-sampler estimator:
gradients flow through every radiance evaluation, while the proposal
density (which only shapes variance, not the expectation) stays
constant. Rendering remains unbiased because the reported pdfs always
describe the sampler actually drawn from.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dj_brdf_tpu.core.pytree import pytree_dataclass


def _build_alias_np(mass: np.ndarray):
    """Pure-numpy Vose fallback (native: io.native.build_alias)."""
    mass = np.asarray(mass, np.float64).reshape(-1)
    n = mass.size
    p = mass / mass.sum() * n
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = list(np.nonzero(p < 1.0)[0])
    large = list(np.nonzero(p >= 1.0)[0])
    while small and large:
        s = small.pop()
        ell = large.pop()
        prob[s] = p[s]
        alias[s] = ell
        p[ell] -= 1.0 - p[s]
        (small if p[ell] < 1.0 else large).append(ell)
    return prob, alias


def _pack_radiance_corners(radiance):
    """(H, W, 3) -> (H*W, 12): the 4 bilinear corner texels of each
    BASE cell (j, i): centers (j, i), (j, i+1 wrap), (j+1 clamp, i),
    (j+1 clamp, i+1 wrap). Traceable (reused by rebind)."""
    h, w, c = radiance.shape
    x01 = jnp.roll(radiance, -1, axis=1)
    down = jnp.concatenate([radiance[1:], radiance[-1:]], axis=0)
    d01 = jnp.roll(down, -1, axis=1)
    return jnp.concatenate([radiance, x01, down, d01], -1) \
        .reshape(h * w, 4 * c)


@pytree_dataclass
class EnvMap:
    """Lat-long environment light with O(1) alias importance tables."""

    radiance: jnp.ndarray   # (H, W, 3)
    packed: jnp.ndarray     # (H*W, 16) 4 bilinear radiance corners
    #                         (12) + the 4 corners' pdf bins (4)
    alias: jnp.ndarray      # (H*W, 4) [prob, alias_idx, pb_self,
    #                         pb_alias]; pb = bin mass/(dtheta*dphi)
    rot: jnp.ndarray | None = None  # optional (3,3) to-world rotation

    # nearest-filter threshold: maps above 2^18 texels pack 16-byte
    # nearest rows instead of 64-byte bilinear rows (a texel there is
    # far below a pixel anyway). The threshold decides the image, so it
    # stays fixed until a measurement on the target device argues for
    # moving it (PERF.md records both frame times).
    NEAREST_AUTO_BINS = 1 << 18

    @classmethod
    def build(cls, radiance, rotation=None, filter: str = "auto"):
        """Precompute sampling tables from an (H, W, 3) lat-long
        radiance image (values >= 0). Host-side, scene-load-time work
        (concrete arrays only): the alias construction is O(H*W)
        native C. For differentiable radiance under a frozen sampler
        (inverse lighting) see :meth:`rebind`.

        ``filter``: "bilinear" packs 4 corner texels + 4 pdf bins per
        row (64-byte rows); "nearest" packs [r, g, b, pdf_bin]
        (16-byte rows — a quarter of the bytes per gather on
        production maps, where a texel is far below a pixel); "auto"
        picks nearest for maps over 256 K texels (2^18 bins)."""
        if isinstance(radiance, jax.core.Tracer):
            raise TypeError(
                "EnvMap.build needs concrete radiance (host-side alias "
                "construction); build once outside jit/grad, then use "
                "EnvMap.rebind(radiance) for differentiable updates")
        if filter not in ("auto", "bilinear", "nearest"):
            raise ValueError(f"unknown filter {filter!r}")
        radiance = jnp.asarray(radiance, jnp.float32)
        h, w = radiance.shape[:2]
        if filter == "auto":
            filter = "nearest" if h * w > cls.NEAREST_AUTO_BINS \
                else "bilinear"
        rad_np = np.asarray(radiance)
        if not np.isfinite(rad_np).all():
            raise ValueError(
                "EnvMap.build: radiance contains non-finite values")
        lum = np.maximum(rad_np, 0.0).mean(-1) + 1e-12
        sin_rows = np.sin((np.arange(h) + 0.5) * (np.pi / h))
        mass = lum * sin_rows[:, None]
        mass = mass / mass.sum()                     # (H, W), sums to 1
        pb = (mass / ((np.pi / h) * (2.0 * np.pi / w))).astype(np.float32)

        try:
            from dj_brdf_tpu.io import native
            prob, alias_idx = native.build_alias(mass)
        except ValueError:
            raise      # the native builder's mass validation is real
        except Exception:
            prob, alias_idx = _build_alias_np(mass)  # no toolchain
        pb_flat = pb.reshape(-1)
        # the partner index rides in the f32 row as its raw int32 BIT
        # PATTERN (bitcast on read) — a float-valued index would round
        # above 2^24 bins and silently redirect draws to neighboring
        # bins on 8K-class maps
        alias_bits = np.ascontiguousarray(alias_idx,
                                          np.int32).view(np.float32)
        alias_tab = jnp.asarray(np.stack(
            [prob, alias_bits, pb_flat, pb_flat[alias_idx]], -1))

        if filter == "nearest":
            packed = jnp.concatenate(
                [radiance.reshape(h * w, 3),
                 jnp.asarray(pb_flat)[:, None]], -1)          # (H*W, 4)
        else:
            pdf_corners = _pack_radiance_corners(
                jnp.asarray(pb)[..., None])                   # (H*W, 4)
            packed = jnp.concatenate(
                [_pack_radiance_corners(radiance), pdf_corners], -1)
        if rotation is not None:
            rotation = jnp.asarray(rotation, jnp.float32)
        return cls(radiance=radiance, packed=packed, alias=alias_tab,
                   rot=rotation)

    @property
    def _nearest(self) -> bool:
        return self.packed.shape[-1] == 4

    def rebind(self, radiance):
        """Return an EnvMap whose radiance (and packed radiance
        texels) are ``radiance`` — traceable and differentiable —
        while the sampling structure (alias table and pdf bins) stays
        frozen at build time. The detached-sampler form of inverse
        lighting: still unbiased (pdfs describe the actual sampler),
        gradients flow through every radiance evaluation."""
        radiance = jnp.asarray(radiance, jnp.float32)
        h, w = radiance.shape[:2]
        if self._nearest:
            packed = jnp.concatenate(
                [radiance.reshape(h * w, 3),
                 jax.lax.stop_gradient(self.packed[:, 3:])], -1)
        else:
            packed = jnp.concatenate(
                [_pack_radiance_corners(radiance),
                 jax.lax.stop_gradient(self.packed[:, 12:])], -1)
        return self.replace(radiance=radiance, packed=packed)

    @staticmethod
    def rotation_z(angle):
        """(3,3) rotation about +z by ``angle`` radians (the common
        lat-long emitter orientation control)."""
        c, s = jnp.cos(angle), jnp.sin(angle)
        return jnp.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                           jnp.float32)

    # -- frames --------------------------------------------------------
    def _to_local(self, dx, dy, dz):
        if self.rot is None:
            return dx, dy, dz
        r = self.rot
        return (r[0, 0] * dx + r[1, 0] * dy + r[2, 0] * dz,
                r[0, 1] * dx + r[1, 1] * dy + r[2, 1] * dz,
                r[0, 2] * dx + r[1, 2] * dy + r[2, 2] * dz)

    def _to_world(self, dx, dy, dz):
        if self.rot is None:
            return dx, dy, dz
        r = self.rot
        return (r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz,
                r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz,
                r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz)

    # -- cells ---------------------------------------------------------
    def _cell_from_grid(self, tg, pg):
        """Packed-row index + filter fractions from LOCAL grid
        coordinates (tg = theta*H/pi in [0,H], pg = phi*W/2pi) —
        trig-free (the sampler knows its grid position exactly).
        Bilinear: the half-shifted base cell + in-cell fractions;
        nearest: the direction's own bin, fractions unused."""
        h, w = self.radiance.shape[:2]
        if self._nearest:
            j0 = jnp.clip(jnp.floor(tg).astype(jnp.int32), 0, h - 1)
            i0 = jnp.mod(jnp.floor(pg).astype(jnp.int32), w)
            zero = jnp.zeros_like(tg)
            return j0 * w + i0, zero, zero
        t1 = jnp.clip(tg - 0.5, 0.0, h - 1.0)
        t2 = pg - 0.5
        j0 = jnp.minimum(jnp.floor(t1).astype(jnp.int32), h - 1)
        i0f = jnp.floor(t2)
        f1 = t1 - j0
        f2 = t2 - i0f
        i0 = jnp.mod(i0f.astype(jnp.int32), w)
        return j0 * w + i0, f1, f2

    def _cell(self, lx, ly, lz):
        """Cell of a LOCAL direction; also returns its floored
        sin(theta) (shared by all pdf paths — one pole floor
        everywhere, so the sampler's pdf and the MIS-side pdf agree
        at the poles)."""
        h, w = self.radiance.shape[:2]
        theta = jnp.arccos(jnp.clip(lz, -1.0, 1.0))
        phi = jnp.arctan2(ly, lx)
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        idx, f1, f2 = self._cell_from_grid(theta * (h / jnp.pi),
                                           phi * (w / (2.0 * jnp.pi)))
        sin_t = jnp.maximum(jnp.sqrt(jnp.maximum(1.0 - lz * lz, 0.0)),
                            1e-6)
        return idx, f1, f2, sin_t

    def _lookup(self, idx, f1, f2):
        """ONE issued row gather: radiance + the direction's exact pdf
        bin. Bilinear mode interpolates the 4 packed corner texels
        (periodic in phi, clamped in theta) and selects the true bin
        by the half-cell bits; nearest mode reads [r, g, b, pb]."""
        if self._nearest:
            row = jnp.take(self.packed, idx, axis=0)        # (..., 4)
            return row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        row = jnp.take(self.packed, idx, axis=0)            # (..., 16)
        f1e = f1[..., None]
        f2e = f2[..., None]
        a = row[..., 0:3] + f2e * (row[..., 3:6] - row[..., 0:3])
        b = row[..., 6:9] + f2e * (row[..., 9:12] - row[..., 6:9])
        rgb = a + f1e * (b - a)
        hi1 = f1 >= 0.5
        hi2 = f2 >= 0.5
        pb = jnp.where(hi1, jnp.where(hi2, row[..., 15], row[..., 14]),
                       jnp.where(hi2, row[..., 13], row[..., 12]))
        return rgb[..., 0], rgb[..., 1], rgb[..., 2], pb

    # -- queries -------------------------------------------------------
    def eval_with_pdf(self, dx, dy, dz):
        """(r, g, b, pdf) toward a WORLD direction: one row gather."""
        lx, ly, lz = self._to_local(dx, dy, dz)
        idx, f1, f2, sin_t = self._cell(lx, ly, lz)
        r, g, b, pb = self._lookup(idx, f1, f2)
        return r, g, b, pb / sin_t

    def eval(self, dx, dy, dz):
        """Filtered radiance only. Returns (r, g, b)."""
        r, g, b, _ = self.eval_with_pdf(dx, dy, dz)
        return r, g, b

    def pdf(self, dx, dy, dz):
        """True sampling density over solid angle at a direction."""
        return self.eval_with_pdf(dx, dy, dz)[3]

    def sample_grid(self, u1, u2, u3):
        """Alias draw: LOCAL grid coordinates (tg, pg) of an
        importance-sampled direction plus its bin density pb — ONE
        gather.

        f32 bit budget (a single 24-bit uniform cannot select among
        2M bins AND drive the accept test AND give in-bin offsets):
        ``u1`` -> row index (exact-uniform; its sub-row fraction is
        the Walker accept threshold, quantized to 2^-14 at H=1024 —
        realized-vs-reported density error is O(2^-14) *relative to
        the whole integral* because L/pdf is bounded by color ratios);
        ``u2`` -> column index (its fraction is the phi in-bin
        offset); ``u3`` -> theta in-bin offset at full precision."""
        h, w = self.radiance.shape[:2]
        xr = jnp.clip(u1, 0.0, 1.0) * h
        j_sel = jnp.minimum(xr.astype(jnp.int32), h - 1)
        frac = xr - j_sel                        # accept threshold
        xc = jnp.clip(u2, 0.0, 1.0) * w
        i_sel = jnp.minimum(xc.astype(jnp.int32), w - 1)
        fc = xc - i_sel                          # phi in-bin offset
        idx = j_sel * w + i_sel                  # uniform over bins

        row = jnp.take(self.alias, idx, axis=0)             # (..., 4)
        prob = row[..., 0]
        take = frac < prob
        alias_idx = jax.lax.bitcast_convert_type(row[..., 1], jnp.int32)
        bin_ = jnp.where(take, idx, alias_idx)
        pb = jnp.where(take, row[..., 2], row[..., 3])
        j = bin_ // w
        i = bin_ - j * w
        fr = jnp.clip(u3, 0.0, 0.999999)
        fc = jnp.clip(fc, 0.0, 0.999999)
        return j + fr, i + fc, pb

    def sample(self, u1, u2, u3):
        """Importance-sample a WORLD direction: (dx, dy, dz, pdf).
        One alias gather; the pdf is the exact density of the draw,
        assembled from the alias row (no second gather)."""
        h, w = self.radiance.shape[:2]
        tg, pg, pb = self.sample_grid(u1, u2, u3)
        theta = tg * (jnp.pi / h)
        phi = pg * (2.0 * jnp.pi / w)
        sin_t = jnp.sin(theta)
        lx = sin_t * jnp.cos(phi)
        ly = sin_t * jnp.sin(phi)
        lz = jnp.cos(theta)
        dx, dy, dz = self._to_world(lx, ly, lz)
        pdf = pb / jnp.maximum(sin_t, 1e-6)
        return dx, dy, dz, pdf


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta=2) weight for strategy a against b."""
    a2 = pdf_a * pdf_a
    denom = a2 + pdf_b * pdf_b
    return jnp.where(denom > 0.0, a2 / jnp.where(denom > 0.0, denom, 1.0),
                     0.0)
