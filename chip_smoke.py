"""Smoke run of the main paths on one GPU: fit, database, aniso, render.

    python chip_smoke.py           # one card, every phase
    python chip_smoke.py --four    # the mesh paths on four cards only

Each phase drives a user entry point at the size users run it, checks
its output against the repo's plain reference, and prints its sizes,
the measured error beside the tolerance, and its compile and
steady-state seconds. The first line is the card's name and power
limit (``nvidia-smi``); every number refers to that card. The last line
is one JSON object ``{"ok": true, "device": {...}}``, printed only when
every phase passed. Without a GPU, or without the package beside this
file, the script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
FIT_N = 1 << 23            # bench.py's fit size
FIT_STEPS = 40
DB_MATERIALS = 100         # the MERL database
DB_FIT_N = 1 << 16
RENDER_RES, RENDER_SPP, RENDER_BOUNCES = 512, 8, 3
MAP_RES = 512
ENV_HW = (1024, 2048)
REF_RES, REF_SPP = 128, 4

# -- tolerances ------------------------------------------------------------
# The hand adjoint and autodiff compute the same f32 loss; on the card
# the 2^23-term sums run in another order (tree reductions, per-block
# partials), and each side rounds its own chain of products.
TOL_FIRST_LOSS = 1e-4
# gradient error relative to the largest gradient component: small
# components are differences of large per-sample terms.
TOL_FIRST_GRAD = 1e-3
# Adam trajectories of two routes (fit_lsq / fit_materials "auto" vs
# "never"): same math, f32 rounding amplified by Adam's normalized steps
# on near-zero gradient components. As the CPU tests (tests/test_ops.py).
TOL_TRAJ_RTOL, TOL_TRAJ_ATOL = 1e-2, 1e-5
TOL_PARAM_RTOL, TOL_PARAM_ATOL = 1e-2, 1e-3
TOL_F0_ATOL = 5e-3
# recovered roughness vs the truth the targets were rendered from
TOL_RECOVER = 0.1
# params.txt vs the pinned alphas: tools/validate_merl_fits.py's own
# PINNED_RTOL (5e-3), which covers params.txt's 3-decimal rounding.
# batched vs single-material tabulation: the same per-material program,
# vmapped or not; XLA may tile the reductions differently.
TOL_BATCH_VS_SINGLE = 1e-4
# device f32 power iteration vs the host f64 one, after normalization
# (tests/test_render_fit_parallel.py, .claude/skills/verify/SKILL.md).
TOL_POWER = 1e-4
# sky-only pixels are one envmap lookup of the camera ray
TOL_SKY = 1e-5
# card vs CPU backend, same threefry bits: transcendentals differ in the
# last ulps between the two backends, and a path whose branch (hit test,
# sampler gate) sits on that last bit takes another route. Pixels agree
# to TOL_PIX_RTOL except at most TOL_PIX_FRAC of them; the image means
# agree to TOL_MEAN.
TOL_PIX_RTOL, TOL_PIX_ATOL = 2e-3, 1e-4
TOL_PIX_FRAC = 0.02
TOL_MEAN = 1e-2
# sharded vs one-card results: identical per-material / per-ray math;
# the power iteration's all_gather changes the matvec's sum order.
TOL_SHARDED = 1e-4
# the one-card batch fit runs the Pallas kernel, the sharded one the XLA
# adjoint (the kernel does not partition): the same sums in another
# order, carried through 300 Adam steps.
TOL_SHARDED_FIT = 1e-3


# -- comparison helpers (tested on the CPU at small sizes) -----------------
def rel_err(got, want) -> float:
    """max |got - want| / max |want| over all leaves of two pytrees."""
    import jax
    g = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(want)]
    g, w = np.concatenate(g), np.concatenate(w)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def traj_err(got, want, rtol, atol) -> float:
    """Largest |got - want| / (atol + rtol |want|): <= 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def pixel_mismatch(img, ref, rtol, atol) -> float:
    """Share of pixels with any channel outside atol + rtol |ref|."""
    img, ref = np.asarray(img, np.float64), np.asarray(ref, np.float64)
    bad = np.abs(img - ref) > atol + rtol * np.abs(ref)
    return float(bad.any(axis=-1).mean())


def parse_params(path) -> dict:
    """params.txt of cli.merl_params -> {name: (beckmann, ggx)}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            name, ab, ag = line.split()
            out[name] = (float(ab), float(ag))
    return out


def pinned_err(params: dict, pinned: dict) -> float:
    """Largest relative alpha error against the pinned table."""
    errs = [abs(v - pinned[name][key]) / pinned[name][key]
            for name, pair in params.items()
            for v, key in zip(pair, ("beckmann", "ggx"))]
    if set(params) != set(pinned):
        raise AssertionError(f"materials {sorted(params)} != pinned "
                             f"{sorted(pinned)}")
    return max(errs)


def camera_dirs(res: int, pixels):
    """World directions of the (unjittered) camera rays of
    ``render.pathtrace.render`` through the given (row, col) pixels."""
    cam = np.asarray([0.0, 3.2, 0.6])
    look = -cam / np.linalg.norm(cam)
    right = np.cross(look, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, look)
    xs = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    out = []
    for r, c in pixels:
        d = look + 0.62 * (xs[c] * right + (-xs[r]) * up)
        out.append(d / np.linalg.norm(d))
    return np.asarray(out, np.float32)


# -- timing ------------------------------------------------------------------
_COMPILE = [0.0]


def _on_event(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILE[0] += duration


def timed(fn):
    """Run fn() to completion: (result, wall seconds, compile seconds)."""
    import jax
    c0, t0 = _COMPILE[0], time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0, _COMPILE[0] - c0


def twice(fn, label: str, reps: int = 1):
    """Cold call, then ``reps`` warm ones: prints compile seconds and
    the median steady seconds (warm wall time less any recompile)."""
    out, wall1, comp1 = timed(fn)
    steady = []
    for _ in range(reps):
        out, wall2, comp2 = timed(fn)
        steady.append(wall2 - comp2)
    print(f"    {label}: compile {comp1:.3f} s (first call {wall1:.3f} s), "
          f"steady {float(np.median(steady)):.6f} s"
          + (f" (median of {reps})" if reps > 1 else ""))
    return out


class Phase:
    def __init__(self):
        self.failed = []

    def check(self, name: str, err: float, tol: float, what: str = "err"):
        ok = bool(np.isfinite(err) and err <= tol)
        print(f"    {name}: {what} {err:.3e} (tol {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def require(self, name: str, cond: bool, detail: str = ""):
        print(f"    {name}: {'ok' if cond else 'FAIL'} {detail}".rstrip())
        if not cond:
            self.failed.append(name)


# -- phases ------------------------------------------------------------------
def _fit_problem(dist, n, seed=SEED):
    import jax
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.fit.batch import sample_direction_set
    from dj_brdf_tpu.microfacet import brdf as mf
    from dj_brdf_tpu.microfacet.params import MicrofacetParams

    i, o = sample_direction_set(jax.random.PRNGKey(seed), n)
    target = mf.evalp(dist, fresnel.Schlick(
        f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32)),
        MicrofacetParams.elliptic(0.3, 0.15, 0.4), i, o)
    return i, o, target


def phase_fit(ph: Phase, n: int = FIT_N, steps: int = FIT_STEPS):
    import jax
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann

    for dist in (GGX(), Beckmann()):
        name = type(dist).__name__
        family = lsq.fused_eligible(dist)
        route = lsq.adjoint_route(dist)
        print(f"  [fit] {name}: fit_lsq N={n} steps={steps} route={route}")
        i, o, target = _fit_problem(dist, n)

        vg, data = lsq.make_fused_value_and_grad(i, o, target, family=family,
                                                 route=route)
        val, g = jax.jit(vg)(lsq.raw_init(), *data)
        with jax.default_matmul_precision("highest"):
            rv, rg = jax.jit(jax.value_and_grad(lsq.make_loss(dist)))(
                lsq.raw_init(), i, o, target)
        ph.check(f"fit.{name}.first_loss", rel_err(val, rv), TOL_FIRST_LOSS)
        ph.check(f"fit.{name}.first_grad", rel_err(g, rg), TOL_FIRST_GRAD)

        pa, fa, la = twice(lambda: lsq.fit_lsq(dist, i, o, target,
                                               steps=steps),
                           f"fit_lsq fused=auto ({route})")
        pn, fn, ln = twice(lambda: lsq.fit_lsq(dist, i, o, target,
                                               steps=steps, fused="never"),
                           "fit_lsq fused=never (autodiff)")
        ph.check(f"fit.{name}.losses", traj_err(la, ln, TOL_TRAJ_RTOL,
                                                TOL_TRAJ_ATOL), 1.0,
                 "err/tol(rtol 1e-2, atol 1e-5)")
        ph.check(f"fit.{name}.params",
                 traj_err([pa.ax, pa.ay, pa.rho], [pn.ax, pn.ay, pn.rho],
                          TOL_PARAM_RTOL, TOL_PARAM_ATOL), 1.0,
                 "err/tol(rtol 1e-2, atol 1e-3)")
        ph.check(f"fit.{name}.f0",
                 float(np.max(np.abs(np.asarray(fa.f0) - fn.f0))),
                 TOL_F0_ATOL, "abs err")
        ph.require(f"fit.{name}.finite", bool(np.isfinite(la).all()),
                   f"loss {float(la[0]):.4e} -> {float(la[-1]):.4e}")


def db_tables(m: int, bases, key):
    """A seeded (m, 3, 90, 90, 180) stack made on the device: per
    material a random mix of the baked base tables times 2% noise
    (below-horizon bins stay negative)."""
    import jax
    import jax.numpy as jnp
    kw, kn = jax.random.split(key)
    w = jax.random.dirichlet(kw, jnp.ones(len(bases)), (m,))
    stack = jnp.stack([jnp.asarray(b) for b in bases])
    tables = jnp.einsum("mk,k...->m...", w, stack)
    noise = 1.0 + 0.02 * jax.random.normal(kn, tables.shape, tables.dtype)
    return tables * noise


def bake_corpus(td: str, ph: Phase, mesh_devices: int = 0):
    """Bake the synthetic corpus into ``td`` as MERL .binary files, run
    ``cli.merl_params`` on them and check params.txt against the
    pinned alphas. Returns the loaded base tables."""
    from dj_brdf_tpu.cli import merl_params
    from dj_brdf_tpu.io import native
    from dj_brdf_tpu.io.merl_io import load_merl
    from tools.validate_merl_fits import (PINNED, PINNED_RTOL,
                                          bake_synthetic_corpus)

    paths = bake_synthetic_corpus(td)
    out = os.path.join(td, "params.txt")
    argv = [*paths, "-o", out]
    if mesh_devices:
        argv += ["--mesh", str(mesh_devices)]
    print(f"  [database] cli.merl_params {' '.join(argv[len(paths):])} on "
          f"{len(paths)} baked MERL files (90x90x180x3)")
    rc = twice(lambda: merl_params.main(argv), "merl_params.main")
    ph.require("database.cli_rc", rc == 0, f"rc={rc}")
    ph.require("database.native_loader", native._lib is not None,
               "(io/native djbio parser loaded)")
    with open(PINNED) as f:
        pinned = json.load(f)
    ph.check("database.pinned_alphas", pinned_err(parse_params(out), pinned),
             PINNED_RTOL, "max rel err")
    return [load_merl(p) for p in paths]


def db_fit_problem(m: int, n: int):
    """Targets (m, n, 3) rendered from known GGX roughness; the truth."""
    import jax
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.fit.batch import sample_direction_set
    from dj_brdf_tpu.microfacet import brdf as mf
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams

    i, o = sample_direction_set(jax.random.PRNGKey(SEED + 1), n)
    alphas = np.linspace(0.15, 0.6, m).astype(np.float32)
    f0 = jnp.asarray([0.9, 0.6, 0.3], jnp.float32)
    targets = jax.vmap(lambda a: mf.evalp(
        GGX(), fresnel.Schlick(f0=f0), MicrofacetParams.isotropic(a),
        i, o))(jnp.asarray(alphas))
    return targets, i, o, alphas


def phase_database(ph: Phase, m: int = DB_MATERIALS, fit_n: int = DB_FIT_N):
    import jax
    from dj_brdf_tpu.fit import moments, tabular
    from dj_brdf_tpu.fit.batch import fit_materials, tabulate_merl_batch
    from dj_brdf_tpu.models.merl import Merl

    with tempfile.TemporaryDirectory() as td:
        bases = bake_corpus(td, ph)

    tables = db_tables(m, bases, jax.random.PRNGKey(SEED))
    print(f"  [database] tabulate_merl_batch: {m} tables "
          f"{tables.nbytes / 2**30:.2f} GiB f32 on the device")
    dists, _, ab, ag = twice(lambda: tabulate_merl_batch(tables, 90),
                             "tabulate_merl_batch")
    ph.require("database.alphas_finite",
               bool(np.isfinite(ab).all() and np.isfinite(ag).all()),
               f"ggx alphas {float(ag.min()):.4f}..{float(ag.max()):.4f}")
    picks = (0, m // 2, m - 1)
    alpha_err, p22_err = 0.0, 0.0
    for k in picks:
        tab, _ = tabular.build_tabular(Merl(table=tables[k]), 90)
        want = np.asarray([moments.fit_beckmann_parameters(tab).ax,
                           moments.fit_ggx_parameters(tab).ax])
        got = np.asarray([ab[k], ag[k]])
        alpha_err = max(alpha_err, float(np.max(np.abs(got - want) / want)))
        p22_err = max(p22_err, rel_err(dists.p22[k], tab.p22))
    ph.check("database.batch_vs_single_alphas", alpha_err,
             TOL_BATCH_VS_SINGLE, f"max rel err (materials {picks})")
    ph.check("database.batch_vs_single_p22", p22_err, TOL_BATCH_VS_SINGLE)

    targets, i, o, alphas = db_fit_problem(m, fit_n)
    print(f"  [database] fit_materials: {m} materials x N={fit_n}")
    pa, _, _ = twice(lambda: fit_materials(targets, i, o),
                     "fit_materials fused=auto")
    pn, _, _ = twice(lambda: fit_materials(targets, i, o, fused="never"),
                     "fit_materials fused=never")
    for name, p in (("auto", pa), ("never", pn)):
        ph.check(f"database.fit_{name}_recovers_alpha",
                 float(np.max(np.abs(np.asarray(p.ax) - alphas) / alphas)),
                 TOL_RECOVER, "max rel err")
    ph.check("database.fit_auto_vs_never",
             traj_err(pa.ax, pn.ax, TOL_PARAM_RTOL, TOL_PARAM_ATOL), 1.0,
             "err/tol(rtol 1e-2, atol 1e-3)")


def _aniso_eval():
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.fit import tabular
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    return tabular.microfacet_eval_fn(
        GGX(), fresnel.Ideal(), MicrofacetParams.elliptic(0.3, 0.15, 0.4))


def phase_aniso(ph: Phase, res: int = 90):
    from dj_brdf_tpu.fit.tabular_aniso import build_tabular_anisotropic
    eval_fn = _aniso_eval()
    n = (res - 1) * res
    print(f"  [aniso] build_tabular_anisotropic {res}x{res}: {n}^2 kernel "
          f"matrix ({n * n * 4 / 2**20:.0f} MiB f32)")
    dev, _ = twice(lambda: build_tabular_anisotropic(eval_fn, res, res,
                                                     power="device"),
                   "power=device (f32 on the card)")
    host, _ = twice(lambda: build_tabular_anisotropic(eval_fn, res, res,
                                                      power="host"),
                    "power=host (f64 on the host)")
    ph.check("aniso.p22_device_vs_host", rel_err(dev.p22, host.p22),
             TOL_POWER)
    ph.check("aniso.sigma_device_vs_host", rel_err(dev.sigma, host.sigma),
             TOL_POWER)
    power_precision_cost(eval_fn, res)


def power_precision_cost(eval_fn, res: int):
    """Time the 4 power-iteration matvecs on the n^2 matrix at the
    pinned HIGHEST precision and at the default one (TF32 on a GPU),
    and print how far the default drifts from HIGHEST."""
    import jax
    import jax.numpy as jnp
    from dj_brdf_tpu.fit.tabular_aniso import kernel_matrix

    A = jax.block_until_ready(kernel_matrix(eval_fn, res, res,
                                            dtype=jnp.float32))
    out = {}
    for name, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                       ("DEFAULT", jax.lax.Precision.DEFAULT)):
        @jax.jit
        def power(A, prec=prec):
            v = jnp.ones((A.shape[0],), A.dtype)
            for _ in range(4):
                v = jnp.matmul(A, v, precision=prec)
            return v
        out[name] = np.asarray(twice(lambda: power(A),
                                     f"4 matvecs precision={name}",
                                     reps=20))
    print(f"    DEFAULT vs HIGHEST iterate: rel err "
          f"{rel_err(out['DEFAULT'], out['HIGHEST']):.3e}")


def matpreview_inputs(seed=SEED, map_res=MAP_RES, env_hw=ENV_HW):
    """Seeded alpha map, LEAN moment maps and lat-long envmap."""
    rng = np.random.default_rng(seed)
    amap = rng.uniform(0.05, 0.6, (map_res, map_res)).astype(np.float32)
    e1 = rng.normal(0.0, 0.15, (map_res, map_res)).astype(np.float32)
    lean1 = np.stack([e1, 0.5 * e1], -1)
    lean2 = np.stack([e1 * e1 + 0.02, 0.25 * e1 * e1 + 0.02,
                      0.5 * e1 * e1], -1).astype(np.float32)
    h, w = env_hw
    env = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
    env[h // 5:h // 5 + max(1, h // 10),
        w // 3:w // 3 + max(1, w // 12)] *= 60.0
    return amap, lean1, lean2, env


def matpreview_scene(amap, lean1, lean2, env, filter="auto"):
    """The materials and envmap that ``cli.render`` builds from the
    same files (--model ggx --alpha1-map --floor-model lean --lean-lod)."""
    import jax.numpy as jnp
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
    from dj_brdf_tpu.lean.lrep import Lrep
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.render.envmap import EnvMap
    from dj_brdf_tpu.render.materials import TexturedMicrofacetMaterial

    sphere = TexturedMicrofacetMaterial(
        dist=GGX(), fres=fresnel.Schlick(f0=jnp.ones(3, jnp.float32)),
        alpha1=jnp.asarray(amap), alpha2=jnp.float32(0.3),
        alpha_angle=jnp.float32(0.0))
    floor = FilteredBeckmannMaterial(
        lean=Lrep(E1=jnp.asarray(lean1[..., 0]), E2=jnp.asarray(lean1[..., 1]),
                  E3=jnp.asarray(lean2[..., 0]), E4=jnp.asarray(lean2[..., 1]),
                  E5=jnp.asarray(lean2[..., 2])),
        base_params=MicrofacetParams.isotropic(0.4),
        eta=jnp.asarray([0.143, 0.375, 1.442], jnp.float32),
        k=jnp.asarray([3.983, 2.386, 1.603], jnp.float32),
        dmap_scale=jnp.float32(1.0), mip_lod=True)
    return sphere, floor, EnvMap.build(jnp.asarray(env), filter=filter)


def render_scene(scene, res, spp, key=None, mesh=None):
    from dj_brdf_tpu.render import pathtrace
    sphere, floor, em = scene
    return pathtrace.render(sphere, floor, (0.3, 0.4, 0.8), (3.0, 3.0, 3.0),
                            (0.3, 0.38, 0.5), res=res, spp=spp,
                            max_bounces=RENDER_BOUNCES, envmap=em, key=key,
                            mesh=mesh)


def phase_render(ph: Phase):
    import jax
    from dj_brdf_tpu.cli import render as render_cli

    amap, lean1, lean2, env = matpreview_inputs()
    with tempfile.TemporaryDirectory() as td:
        files = {}
        for name, arr in (("a", amap), ("l1", lean1), ("l2", lean2),
                          ("env", env)):
            files[name] = os.path.join(td, f"{name}.npy")
            np.save(files[name], arr)
        out = os.path.join(td, "out.npy")
        argv = ["--pathtrace", "--model", "ggx", "--alpha1-map", files["a"],
                "--floor-model", "lean", "--lean-lod",
                "--floor-leanmap1", files["l1"],
                "--floor-leanmap2", files["l2"], "--envmap", files["env"],
                "--res", str(RENDER_RES), "--spp", str(RENDER_SPP),
                "--bounces", str(RENDER_BOUNCES), "-o", out]
        print(f"  [render] cli.render --pathtrace {RENDER_RES}^2 x "
              f"{RENDER_SPP} spp, {RENDER_BOUNCES} bounces, {MAP_RES}^2 "
              f"alpha + LEAN maps, {ENV_HW[0]}x{ENV_HW[1]} envmap")
        rc = twice(lambda: render_cli.main(argv), "render.main")
        ph.require("render.cli_rc", rc == 0, f"rc={rc}")
        img = np.load(out)

    scene = matpreview_scene(amap, lean1, lean2, env)
    ph.require("render.shape_finite",
               img.shape == (RENDER_RES, RENDER_RES, 3)
               and bool(np.isfinite(img).all()),
               f"shape {img.shape}, mean {float(img.mean()):.5f}")
    corners = [(0, 0), (0, RENDER_RES - 1)]
    sky = np.stack(scene[2].eval(*camera_dirs(RENDER_RES, corners).T), -1)
    got = np.stack([img[r, c] for r, c in corners])
    ph.check("render.sky_corners", rel_err(got, sky), TOL_SKY)

    key = jax.random.PRNGKey(SEED)
    print(f"  [render] card vs CPU backend: {REF_RES}^2 x {REF_SPP} spp, "
          "same threefry key")
    gpu = twice(lambda: render_scene(scene, REF_RES, REF_SPP, key),
                "pathtrace.render on the card")
    cpu = jax.devices("cpu")[0]
    scene_cpu = jax.device_put(scene, cpu)
    ref, wall, comp = timed(lambda: render_scene(
        scene_cpu, REF_RES, REF_SPP, jax.device_put(key, cpu)))
    ref = np.asarray(ref)
    print(f"    pathtrace.render on the CPU: {wall:.3f} s with "
          f"{comp:.3f} s compile")
    ph.check("render.card_vs_cpu_pixels",
             pixel_mismatch(gpu, ref, TOL_PIX_RTOL, TOL_PIX_ATOL),
             TOL_PIX_FRAC, "share of pixels off")
    ph.check("render.card_vs_cpu_mean",
             abs(float(np.mean(gpu)) / float(np.mean(ref)) - 1.0), TOL_MEAN,
             "rel err")

    for filt in ("nearest", "bilinear"):
        sc = matpreview_scene(amap, lean1, lean2, env, filter=filt)
        twice(lambda: render_scene(sc, RENDER_RES, RENDER_SPP),
              f"frame {RENDER_RES}^2x{RENDER_SPP}spp envmap "
              f"filter={filt}", reps=10)
    return scene


def phase_four(ph: Phase, m: int = DB_MATERIALS, fit_n: int = DB_FIT_N):
    """The mesh paths over make_mesh(4), each against one card."""
    import jax
    from dj_brdf_tpu.fit.batch import fit_materials, tabulate_merl_batch
    from dj_brdf_tpu.fit.tabular_aniso import build_tabular_anisotropic
    from dj_brdf_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    with tempfile.TemporaryDirectory() as td:
        bases = bake_corpus(td, ph, mesh_devices=4)
    tables = db_tables(m, bases, jax.random.PRNGKey(SEED))
    print(f"  [four] tabulate_merl_batch: {m} tables, one card vs mesh=4")
    _, _, ab1, ag1 = twice(lambda: tabulate_merl_batch(tables, 90),
                           "one card")
    _, _, ab4, ag4 = twice(lambda: tabulate_merl_batch(tables, 90,
                                                       mesh=mesh), "mesh=4")
    ph.check("four.tabulate_alphas", rel_err((ab4, ag4), (ab1, ag1)),
             TOL_SHARDED)
    del tables

    targets, i, o, _ = db_fit_problem(m, fit_n)
    print(f"  [four] fit_materials: {m} materials x N={fit_n}, one card "
          "vs mesh=4")
    p1, f1, l1 = twice(lambda: fit_materials(targets, i, o), "one card")
    p4, f4, l4 = twice(lambda: fit_materials(targets, i, o, mesh=mesh),
                       "mesh=4")
    ph.check("four.fit_materials", rel_err((p4.ax, f4.f0, l4),
                                           (p1.ax, f1.f0, l1)),
             TOL_SHARDED_FIT)

    print("  [four] anisotropic 90x90: sharded power iteration vs one card")
    eval_fn = _aniso_eval()
    dev, _ = twice(lambda: build_tabular_anisotropic(eval_fn, 90, 90,
                                                     power="device"),
                   "one card power=device")
    sh, _ = twice(lambda: build_tabular_anisotropic(eval_fn, 90, 90,
                                                    mesh=mesh),
                  "mesh=4 (shard_map + all_gather)")
    ph.check("four.aniso_p22", rel_err(sh.p22, dev.p22), TOL_SHARDED)

    print(f"  [four] pathtrace.render {RENDER_RES}^2 x {RENDER_SPP} spp "
          "matpreview, rays sharded over 4 cards")
    scene = matpreview_scene(*matpreview_inputs())
    key = jax.random.PRNGKey(SEED)
    a = np.asarray(twice(lambda: render_scene(scene, RENDER_RES, RENDER_SPP,
                                              key), "one card"))
    b = np.asarray(twice(lambda: render_scene(scene, RENDER_RES, RENDER_SPP,
                                              key, mesh=mesh), "mesh=4"))
    print(f"    render bit-equal: {bool(np.array_equal(a, b))}, "
          f"max abs diff {float(np.max(np.abs(a - b))):.3e}")
    ph.check("four.render_pixels",
             pixel_mismatch(b, a, TOL_PIX_RTOL, TOL_PIX_ATOL), TOL_PIX_FRAC,
             "share of pixels off")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh paths, on four cards")
    args = ap.parse_args(argv)

    # the render phase compares against this process's CPU backend
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing run", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: {want} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from dj_brdf_tpu.config import setup_compile_cache
        import tools.validate_merl_fits  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dj_brdf_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    print(card_line())
    print(f"  [device] {devices[0].platform} {devices[0].device_kind} x "
          f"{len(devices)}; jax {jax.__version__}; compile cache "
          f"{setup_compile_cache()}")
    jax.monitoring.register_event_duration_secs_listener(_on_event)

    ph = Phase()
    phases = ([("four", phase_four)] if args.four else
              [("fit", phase_fit), ("database", phase_database),
               ("aniso", phase_aniso), ("render", phase_render)])
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(ph)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            ph.failed.append(f"{name} (raised)")
        print(f"  [{name}] {time.perf_counter() - t0:.1f} s", flush=True)
    peak = devices[0].memory_stats().get("peak_bytes_in_use", 0)
    print(f"  [total] {time.perf_counter() - t_all:.1f} s; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    if ph.failed:
        print(f"chip_smoke: FAILED {ph.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
