"""Benchmarks on one GPU. Headline: the GGX fit loss forward+backward
throughput (the reference's hot loop, dj_brdf.h:1529-1547) through the
product's routed hand adjoint (``fit.lsq.adjoint_route``). Prints ONE
JSON line; vs_baseline is against a fixed 1e9 evals/s reference rate.

Secondary metrics (stderr `# name: value`): measured-table eval
throughput (MERL dj_brdf.h:987-1024, UTIA 1063-1157), VNDF sampling
hot loops (Beckmann Halley qf2 dj_brdf.h:1897-1952, GGX closed form
2089-2146, spherical-caps variant), end-to-end fit steps, path-tracer
sample rates, and the anisotropic power-iteration matvec
(dj_brdf.h:2467-2480 at the production 90x90 kernel size).

The run fails (non-zero exit, no JSON line) without a GPU, and exits
non-zero after printing when any secondary metric failed.

Run: `python bench.py`. Optional env:
  BENCH_N        batch size per step   (default 2^23)
  BENCH_ITERS    timed iterations      (default 200)
  BENCH_SECONDARY=0   skip secondary metrics
  BENCH_BATCH=0       skip the 100-material tabulation
  BENCH_ANISO=0       skip the 90x90 anisotropic fit timing
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def _timeit_stats(step, iters: int, rounds: int = 3, agree: float = 0.10,
                  max_rounds: int = 8) -> dict:
    """Wall-time statistics for `iters` calls of step(), syncing through
    a scalar readback of step's return value.

    Rounds repeat until the two FASTEST rounds agree to `agree`
    (default 10%) or `max_rounds` is hit, and the spread is reported
    alongside the best so a noisy capture is visible in the record
    instead of silently becoming the number."""
    float(step())  # warmup (compile + first dispatch)
    times = []
    while True:
        t0 = time.perf_counter()
        s = None
        for _ in range(iters):
            s = step()
        float(s)  # force full device sync + readback
        times.append(time.perf_counter() - t0)
        if len(times) >= rounds:
            srt = sorted(times)
            if (srt[1] / max(srt[0], 1e-12) - 1.0 <= agree
                    or len(times) >= max_rounds):
                break
    srt = sorted(times)
    n = len(times)
    mean = sum(times) / n
    var = sum((t - mean) ** 2 for t in times) / n
    stats = {"best": srt[0], "median": srt[n // 2],
             "cv": (var ** 0.5) / max(mean, 1e-12), "rounds": n,
             "agreed": srt[1] / max(srt[0], 1e-12) - 1.0 <= agree}
    _LAST_STATS.clear()
    _LAST_STATS.update(stats)
    return stats


def _timeit(step, iters: int, rounds: int = 3) -> float:
    return _timeit_stats(step, iters, rounds)["best"]


def _rand_dirs(key, n):
    from dj_brdf_tpu.core.math import from_spherical
    k1, k2 = jax.random.split(key)
    return from_spherical(jax.random.uniform(k1, (n,), minval=0.02, maxval=1.5),
                          jax.random.uniform(k2, (n,), maxval=2 * jnp.pi))


def main() -> int:
    from dj_brdf_tpu.config import setup_compile_cache
    from dj_brdf_tpu.fit import lsq
    from dj_brdf_tpu.microfacet.ndf import GGX
    from dj_brdf_tpu.ops import soa

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"# bench: no GPU (JAX found {dev.platform}); nothing run",
              file=sys.stderr)
        return 1
    setup_compile_cache()
    n = int(os.environ.get("BENCH_N", 1 << 23))
    iters = int(os.environ.get("BENCH_ITERS", 200))
    print(f"# device: {dev.platform} {dev.device_kind} x "
          f"{len(jax.devices())}", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    ki, ko = jax.random.split(key)
    i = _rand_dirs(ki, n)
    o = _rand_dirs(ko, n)
    pvec_true = jnp.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                            jnp.float32)
    target = jnp.stack(soa.ggx_evalp_soa(pvec_true, *soa.split_dirs(i, o)),
                       -1)
    route = lsq.adjoint_route(GGX())
    vg, data = lsq.make_fused_value_and_grad(i, o, target, family="ggx",
                                             route=route)
    vg = jax.jit(vg)
    raw = lsq.raw_init()

    def step():
        val, grads = vg(raw, *data)
        return val + grads.log_ax
    print(f"# headline route: {route}", file=sys.stderr)

    hstats = _timeit_stats(step, iters, max_rounds=12)
    evals_per_s = n * iters / hstats["best"]
    print(f"# headline: {evals_per_s:.3e} evals/s  "
          f"(rounds={hstats['rounds']} cv={hstats['cv']:.3f} "
          f"agreed={hstats['agreed']})", file=sys.stderr)

    failed = []
    if os.environ.get("BENCH_SECONDARY", "1") == "1":
        try:
            failed = _secondary_metrics(i, o, n, min(iters, 100))
        except Exception as e:
            print(f"# secondary metrics aborted: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed = ["secondary"]

    print(json.dumps({
        "metric": "ggx_fit_fwdbwd_evals_per_s",
        "value": evals_per_s,
        "unit": "evals/s",
        "vs_baseline": evals_per_s / 1e9,
        "spread_cv": hstats["cv"],
        "rounds": hstats["rounds"],
        "rounds_agreed_10pct": hstats["agreed"],
        "route": route,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "failed_metrics": failed,
    }))
    return 1 if failed else 0


_LAST_STATS: dict = {}     # spread of the most recent _timeit_stats


def _metric(name, fn, unit="evals/s", target=None):
    """Time a secondary metric; emits a human line and a JSON record
    (stderr, so stdout stays the single headline JSON line). The
    record carries the spread of the metric's final timing loop. A
    metric that raises is reported and recorded in ``_FAILED``."""
    try:
        _LAST_STATS.clear()
        v = fn()
        print(f"# {name}: {v:.3e}", file=sys.stderr)
        rec = {"metric": name, "value": v, "unit": unit}
        if target:
            rec["vs_baseline"] = v / target
        if _LAST_STATS:
            rec["spread_cv"] = _LAST_STATS["cv"]
            rec["rounds"] = _LAST_STATS["rounds"]
            rec["rounds_agreed_10pct"] = _LAST_STATS["agreed"]
        print(json.dumps(rec), file=sys.stderr)
    except Exception as e:
        print(f"# {name} failed: {type(e).__name__}: {e}", file=sys.stderr)
        _FAILED.append(name)


_FAILED: list = []


def _secondary_metrics(i, o, n, iters: int) -> list:
    """Run every secondary metric; returns the names of those that
    failed."""
    from dj_brdf_tpu import fresnel
    from dj_brdf_tpu.microfacet import brdf as mf
    from dj_brdf_tpu.microfacet.ndf import GGX, GGXSphericalCaps, Beckmann
    from dj_brdf_tpu.microfacet.params import MicrofacetParams
    from dj_brdf_tpu.models.merl import Merl
    from dj_brdf_tpu.models.utia import Utia

    key = jax.random.PRNGKey(7)
    ku1, ku2, kt1, kt2 = jax.random.split(key, 4)
    u1 = jax.random.uniform(ku1, (n,))
    u2 = jax.random.uniform(ku2, (n,))

    # --- measured-table eval (synthetic tables made on the device; the
    # values are irrelevant for perf). Models are passed as jit
    # ARGUMENTS: closure-captured tables become XLA constants
    # (DESIGN.md "Measured-table gathers").
    m = Merl(table=jax.random.uniform(kt1, (3, 90, 90, 180), jnp.float32))
    merl_step = jax.jit(lambda m, i, o: m.evalp(i, o).sum())

    def merl_eval():
        dt = _timeit(lambda: merl_step(m, i, o), iters)
        return n * iters / dt
    _metric("merl_eval_evals_per_s", merl_eval, target=1e9)

    u = Utia.build(jax.random.uniform(kt2, (3, 6, 48, 6, 48), jnp.float32)
                   * 0.1)
    utia_step = jax.jit(lambda u, i, o: u.evalp(i, o).sum())

    def utia_eval():
        dt = _timeit(lambda: utia_step(u, i, o), iters)
        return n * iters / dt
    _metric("utia_eval_evals_per_s", utia_eval, target=1e9)

    # --- VNDF sampling hot loop: sample + evalp_is weight
    # (dj_brdf.h:1734-1765; Beckmann Newton solver 1897-1952, GGX
    # closed forms 2089-2146, spherical-caps sampler ndf.py)
    params = MicrofacetParams.elliptic(0.3, 0.15, 0.7)
    fres = fresnel.Schlick(f0=jnp.asarray([0.9, 0.6, 0.3], jnp.float32))

    def sample_rate(dist):
        stp = jax.jit(lambda p, f, u1, u2, o: sum(
            jnp.sum(x) for x in jax.tree_util.tree_leaves(
                mf.evalp_is(dist, f, p, u1, u2, o))))
        dt = _timeit(lambda: stp(params, fres, u1, u2, o), iters)
        return n * iters / dt

    _metric("beckmann_sample_evalp_is_per_s", lambda: sample_rate(Beckmann()))
    _metric("ggx_sample_evalp_is_per_s", lambda: sample_rate(GGX()))
    _metric("ggx_caps_sample_evalp_is_per_s",
            lambda: sample_rate(GGXSphericalCaps()))

    # fused SoA sample+eval (ops/soa.py): one pass shares the receiver
    # warp / sigma / slope work the layered path recomputes
    from dj_brdf_tpu.ops.soa import beckmann_evalp_is_soa, ggx_evalp_is_soa

    def fused_sample_rate(kernel):
        pv = jnp.stack([params.ax, params.ay, params.rho, params.txn,
                        params.tyn] + list(fres.f0)).astype(jnp.float32)
        stp = jax.jit(lambda pv, u1, u2, ox, oy, oz: sum(
            jnp.sum(x) for x in kernel(pv, u1, u2, ox, oy, oz)))
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
        dt = _timeit(lambda: stp(pv, u1, u2, ox, oy, oz), iters)
        return n * iters / dt
    _metric("ggx_caps_evalp_is_soa_per_s", lambda: fused_sample_rate(
        functools.partial(ggx_evalp_is_soa, caps=True)))
    _metric("ggx_qf_evalp_is_soa_per_s", lambda: fused_sample_rate(
        functools.partial(ggx_evalp_is_soa, caps=False)))
    _metric("beckmann_evalp_is_soa_per_s",
            lambda: fused_sample_rate(beckmann_evalp_is_soa))

    # --- END-TO-END fit steps: the *product* fitting path (the routed
    # hand adjoint + raw_to_pvec chain rule + adam update), GGX and
    # Beckmann (the reference's co-equal pair, dj_brdf.h:3133-3184)
    def fit_step_rate(dist, evalp_soa):
        import optax

        from dj_brdf_tpu.fit import lsq
        from dj_brdf_tpu.ops import soa

        pvec_true = jnp.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                                jnp.float32)
        target = jnp.stack(evalp_soa(pvec_true, *soa.split_dirs(i, o)), -1)
        vg, data = lsq.make_fused_value_and_grad(
            i, o, target, family=lsq.fused_eligible(dist),
            route=lsq.adjoint_route(dist))
        opt = optax.adam(5e-2)
        state = {"raw": lsq.raw_init()}
        state["opt"] = opt.init(state["raw"])

        @jax.jit
        def step_fn(raw, opt_state, *data):
            val, grads = vg(raw, *data)
            updates, opt_state = opt.update(grads, opt_state)
            raw = optax.apply_updates(raw, updates)
            return raw, opt_state, val

        def stp():
            state["raw"], state["opt"], val = step_fn(
                state["raw"], state["opt"], *data)
            return val

        dt = _timeit(stp, iters)
        return n * iters / dt

    from dj_brdf_tpu.ops.soa import beckmann_evalp_soa, ggx_evalp_soa
    _metric("fit_step_evals_per_s",
            lambda: fit_step_rate(GGX(), ggx_evalp_soa), target=1e9)
    _metric("fit_step_beckmann_evals_per_s",
            lambda: fit_step_rate(Beckmann(), beckmann_evalp_soa),
            target=1e9)

    # --- batched multi-material fit step (fit/batch.py: on a GPU one
    # kernel launch, direction blocks read once for all materials)
    def fit_batch_step_rate():
        import optax

        from dj_brdf_tpu.fit import lsq
        from dj_brdf_tpu.fit.batch import make_batched_value_and_grad
        from dj_brdf_tpu.ops import soa

        m = 16
        nm = n // 8  # per-material sample count
        pvec_true = jnp.asarray([0.25, 0.25, 0.0, 0.0, 0.0, 0.9, 0.6, 0.3],
                                jnp.float32)
        tgt = jnp.stack(soa.ggx_evalp_soa(
            pvec_true, *soa.split_dirs(i[:nm], o[:nm])), -1)
        sc = jnp.linspace(0.5, 2.0, m, dtype=jnp.float32)[:, None, None]
        vg, data = make_batched_value_and_grad(
            tgt[None] * sc, i[:nm], o[:nm], GGX(),
            lsq.adjoint_route(GGX()))

        raw0 = jax.vmap(lambda _: lsq.raw_init())(jnp.arange(m))
        opt = optax.adam(5e-2)
        state = {"raw": raw0, "opt": opt.init(raw0)}

        @jax.jit
        def step_fn(raw, opt_state, *data):
            per_mat, graw = vg(raw, *data)
            updates, opt_state = opt.update(graw, opt_state)
            raw = optax.apply_updates(raw, updates)
            return raw, opt_state, per_mat.sum()

        def stp():
            state["raw"], state["opt"], val = step_fn(
                state["raw"], state["opt"], *data)
            return val

        it2 = max(1, iters // 2)
        dt = _timeit(stp, it2)
        return m * nm * it2 / dt
    _metric("fit_batch_step_evals_per_s", fit_batch_step_rate, target=1e9)

    # --- path tracer (render/pathtrace.py; the reference delegates to
    # Mitsuba's integrator around its BSDF plugins)
    def pathtrace_rate(floor_dist):
        from dj_brdf_tpu.render import materials, pathtrace
        sphere = materials.MicrofacetMaterial(dist=GGX(), fres=fres,
                                              params=params)
        floor = materials.MicrofacetMaterial(
            dist=floor_dist,
            fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(0.5))
        light = jnp.asarray([0.3, 0.4, 0.8], jnp.float32)
        res, spp = 512, 8
        key = jax.random.PRNGKey(0)

        def stp():
            img = pathtrace.render(sphere, floor, light,
                                   jnp.asarray([4.0, 4.0, 4.0]),
                                   jnp.asarray([0.3, 0.35, 0.4]),
                                   res=res, spp=spp, max_bounces=3,
                                   key=key)
            return img.sum()
        dt = _timeit(stp, max(1, iters // 4))
        return res * res * spp * max(1, iters // 4) / dt
    # mixed-family scene (GGX sphere / Beckmann floor, the matpreview
    # analogue): one dual-family SoA kernel per bounce, bounded by the
    # Beckmann lanes' transcendental count
    _metric("pathtrace_samples_per_s", lambda: pathtrace_rate(Beckmann()),
            unit="samples/s")
    # same-family scene: per-ray pvec select, single kernel per bounce
    _metric("pathtrace_ggx_samples_per_s", lambda: pathtrace_rate(GGX()),
            unit="samples/s")

    # environment-lit MIS transport (render/envmap.py + the SoA envmap
    # loop): per-bounce emitter sampling/eval is made of table gathers
    # (DESIGN.md "Environment-map lighting"), a table workload, not a
    # kernel workload. Two map sizes: 32x64 and a production 1024x2048
    # lat-long (the matpreview-class emitter) — the alias sampler's
    # per-draw cost is size-independent, so the two should track.
    def pathtrace_env_rate(h, w):
        import numpy as np
        from dj_brdf_tpu.render import materials, pathtrace
        from dj_brdf_tpu.render.envmap import EnvMap
        rng = np.random.default_rng(0)
        img = np.abs(rng.normal(1.0, 0.5, (h, w, 3))).astype(np.float32)
        img[h // 5:h // 5 + max(1, h // 10),
            w // 3:w // 3 + max(1, w // 12)] *= 60.0
        em = EnvMap.build(jnp.asarray(img))
        sphere = materials.MicrofacetMaterial(dist=GGX(), fres=fres,
                                              params=params)
        floor = materials.MicrofacetMaterial(
            dist=Beckmann(),
            fres=fresnel.Schlick(f0=jnp.asarray([0.3, 0.3, 0.3])),
            params=MicrofacetParams.isotropic(0.5))
        res, spp = 256, 8
        rkey = jax.random.PRNGKey(0)

        def stp():
            out = pathtrace.render(
                sphere, floor, jnp.asarray([0.3, 0.4, 0.8]),
                jnp.zeros(3), jnp.zeros(3), res=res, spp=spp,
                max_bounces=3, envmap=em, key=rkey)
            return out.sum()
        dt = _timeit(stp, max(1, iters // 4))
        return res * res * spp * max(1, iters // 4) / dt
    _metric("pathtrace_envmap_samples_per_s",
            lambda: pathtrace_env_rate(32, 64), unit="samples/s")
    _metric("pathtrace_envmap_1024x2048_samples_per_s",
            lambda: pathtrace_env_rate(1024, 2048), unit="samples/s")

    # textured matpreview-class frame: per-hit alpha-texture +
    # full-map LEAN fetches inside the bounce loop + envmap MIS
    # (the integrator-orthogonal path)
    def pathtrace_textured_rate():
        import numpy as np
        from dj_brdf_tpu.lean.filtered import FilteredBeckmannMaterial
        from dj_brdf_tpu.lean.lrep import Lrep
        from dj_brdf_tpu.render import pathtrace
        from dj_brdf_tpu.render.envmap import EnvMap
        from dj_brdf_tpu.render.materials import \
            TexturedMicrofacetMaterial
        rng = np.random.default_rng(0)
        img = np.abs(rng.normal(1.0, 0.5, (256, 512, 3))).astype(
            np.float32)
        img[50:60, 160:170] *= 60.0
        em = EnvMap.build(jnp.asarray(img))
        amap = jnp.asarray(rng.uniform(0.05, 0.6, (512, 512)),
                           jnp.float32)
        sphere = TexturedMicrofacetMaterial(
            dist=GGX(), fres=fres, alpha1=amap, alpha2=amap,
            alpha_angle=jnp.asarray(0.0, jnp.float32))
        e1 = jnp.asarray(rng.normal(0, 0.15, (512, 512)), jnp.float32)
        floor = FilteredBeckmannMaterial(
            lean=Lrep(E1=e1, E2=e1 * 0.5, E3=e1 * e1 + 0.02,
                      E4=0.25 * e1 * e1 + 0.02, E5=0.5 * e1 * e1),
            base_params=MicrofacetParams.isotropic(0.1),
            eta=jnp.asarray([0.143, 0.375, 1.442], jnp.float32),
            k=jnp.asarray([3.983, 2.386, 1.603], jnp.float32),
            mip_lod=True)  # ray-cone LOD
        res, spp = 256, 8
        rkey = jax.random.PRNGKey(0)

        def stp():
            out = pathtrace.render(
                sphere, floor, jnp.asarray([0.3, 0.4, 0.8]),
                jnp.zeros(3), jnp.zeros(3), res=res, spp=spp,
                max_bounces=3, envmap=em, key=rkey)
            return out.sum()
        dt = _timeit(stp, max(1, iters // 4))
        return res * res * spp * max(1, iters // 4) / dt
    _metric("pathtrace_matpreview_samples_per_s", pathtrace_textured_rate,
            unit="samples/s")

    # --- power-iteration matvec at the production aniso kernel size
    # (8010^2, dj_brdf.h:2525-2579), on-device f32
    def matvec_rate():
        rows = 89 * 90
        A = jax.random.uniform(jax.random.PRNGKey(1), (rows, rows),
                               jnp.float32)
        v = jnp.ones((rows,), jnp.float32)

        @jax.jit
        def four(A, v):
            for _ in range(4):
                v = A @ v
            return v[0]

        dt = _timeit(lambda: four(A, v), iters)
        return 4 * iters / dt
    _metric("power_iteration_matvecs_per_s_n8010", matvec_rate,
            unit="matvecs/s")

    # --- 100-material batched tabulation at res 90: the whole MERL
    # database in one vmapped device program (fit/batch.py; the
    # reference's examples/merl_params.cpp loops one material at a
    # time on one CPU core)
    if os.environ.get("BENCH_BATCH", "1") == "1":
        def batch_rate():
            from dj_brdf_tpu.fit.batch import tabulate_merl_batch
            M = 100
            tables = jax.random.uniform(
                jax.random.PRNGKey(2), (M, 3, 90, 90, 180),
                jnp.float32) * 0.5

            def stp():
                dists, _, ab, ag = tabulate_merl_batch(tables, 90)
                return ab.sum() + ag.sum() + dists.qf.sum()
            dt = _timeit(stp, 1)
            return M / dt
        _metric("batch_tabulate_res90_materials_per_s", batch_rate,
                unit="materials/s")

    # --- full anisotropic tabulation at production resolution 90x90
    # (the reference's biggest workload, dj_brdf.h:2238-2273)
    if os.environ.get("BENCH_ANISO", "1") == "1":
        def aniso_wall():
            from dj_brdf_tpu.fit.tabular_aniso import build_tabular_anisotropic
            from dj_brdf_tpu.microfacet.params import MicrofacetParams as MP
            dist0 = GGX()
            fres0 = fresnel.Ideal()
            p0 = MP.elliptic(0.3, 0.15, 0.4)

            def eval_fn(di, do):
                return mf.eval(dist0, fres0, p0, di, do)

            def run():
                t0 = time.perf_counter()
                dist, _ = build_tabular_anisotropic(eval_fn, 90, 90)
                float(dist.p22.sum())  # sync
                return time.perf_counter() - t0

            run()  # warm the (persistent-cached) compiles
            return min(run(), run())
        _metric("aniso_fit90_wall_seconds", aniso_wall, unit="s")
    return list(_FAILED)


if __name__ == "__main__":
    raise SystemExit(main())
