"""Time the fit step with the Triton-route kernel against the XLA adjoint.

One fit step is the hand adjoint, the chain rule through
``raw_to_pvec`` and one Adam update, as ``fit.batch.fit_materials``
runs it; M = 1 uses the unbatched form of ``fit.lsq.fit_lsq``. Both
routes run inside one jitted ``lax.scan`` of ``--steps`` steps, in the
order kernel, XLA, XLA, kernel, and each is checked against the other
at the first step.

    python tools/fit_adjoint_timing.py [--json results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from dj_brdf_tpu.fit import lsq  # noqa: E402
from dj_brdf_tpu.fit.batch import sample_direction_set  # noqa: E402
from dj_brdf_tpu.ops import soa  # noqa: E402
from dj_brdf_tpu.ops.fused_fit import lsq_value_and_grad_batched  # noqa: E402

_FWDBWD = {"ggx": soa.ggx_lsq_fwdbwd_soa, "beck": soa.beckmann_lsq_fwdbwd_soa}
_EVAL = {"ggx": soa.ggx_evalp_soa, "beck": soa.beckmann_evalp_soa}


def make_data(family, m, n):
    i, o = sample_direction_set(jax.random.PRNGKey(0), n)
    comp = soa.split_dirs(i, o)
    alphas = jnp.linspace(0.1, 0.6, m, dtype=jnp.float32)
    pv = jnp.stack([alphas, alphas * 0.8, jnp.zeros(m), jnp.zeros(m),
                    jnp.zeros(m), jnp.full(m, 0.9), jnp.full(m, 0.6),
                    jnp.full(m, 0.3)], axis=1).astype(jnp.float32)
    tr, tg, tb = jax.vmap(lambda p: _EVAL[family](p, *comp))(pv)
    return jax.block_until_ready((*comp, tr, tg, tb))


def make_run(route, family, m, n, steps, block=512, num_warps=4):
    opt = optax.adam(5e-2)
    fwdbwd = _FWDBWD[family]

    def vg(raw, *data):
        pvecs, vjp = jax.vjp(jax.vmap(soa.raw_to_pvec), raw)
        if route == "kernel":
            sums, gsums = lsq_value_and_grad_batched(
                pvecs, *data, family=family, block=block,
                num_warps=num_warps)
        elif m == 1:
            s, g = fwdbwd(pvecs[0], *data[:6], *(t[0] for t in data[6:]))
            sums, gsums = s[None], g[None]
        else:
            sums, gsums = jax.vmap(
                lambda pv, a, b, c: fwdbwd(pv, *data[:6], a, b, c))(
                    pvecs, *data[6:])
        (graw,) = vjp(gsums / (n * m))
        return sums / n, gsums / n, graw

    @jax.jit
    def first(raw, *data):
        return vg(raw, *data)[:2]

    @jax.jit
    def run(raw, opt_state, *data):
        def step(carry, _):
            raw, opt_state = carry
            val, _, grads = vg(raw, *data)
            updates, opt_state = opt.update(grads, opt_state)
            return (optax.apply_updates(raw, updates), opt_state), val

        (raw, opt_state), losses = jax.lax.scan(step, (raw, opt_state),
                                                None, length=steps)
        return raw, opt_state, losses

    raw0 = jax.vmap(lambda _: lsq.raw_init())(jnp.arange(m))
    return first, run, raw0, opt.init(raw0)


def time_run(run, raw, st, data, rounds):
    t0 = time.perf_counter()
    jax.block_until_ready(run(raw, st, *data))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(run(raw, st, *data))
        ts.append(time.perf_counter() - t0)
    return compile_s, ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    shapes = [("ggx", 1, 1 << 23), ("beck", 1, 1 << 23),
              ("ggx", 16, 1 << 20), ("beck", 16, 1 << 20),
              ("ggx", 100, 1 << 20)]
    configs = [(256, 4), (512, 4), (1024, 8)]
    out = []
    for family, m, n in shapes:
        data = make_data(family, m, n)
        runs = {"xla": make_run("xla", family, m, n, args.steps)}
        for b, w in configs:
            runs[f"kernel_b{b}_w{w}"] = make_run("kernel", family, m, n,
                                                 args.steps, b, w)
        ref_l, ref_g = runs["xla"][0](runs["xla"][2], *data)
        res = {}
        for name, (first, run, raw, st) in runs.items():
            try:
                l, g = first(raw, *data)
                err = float(jnp.max(jnp.abs(g - ref_g)
                                    / (jnp.abs(ref_g) + 1e-6)))
                lerr = float(jnp.max(jnp.abs(l - ref_l) / jnp.abs(ref_l)))
                res[name] = {"loss_rel_err": lerr, "grad_rel_err": err,
                             "times": []}
            except Exception as e:  # report and go on to the next config
                print(f"{family} M={m} {name} failed: "
                      f"{type(e).__name__}: {str(e)[:2000]}")
        order = [k for k in res if k != "xla"]
        # kernel configs, xla, xla, kernel configs reversed
        for name in order + ["xla", "xla"] + order[::-1]:
            first, run, raw, st = runs[name]
            c, ts = time_run(run, raw, st, data, args.rounds)
            res[name]["times"] += ts
            res[name].setdefault("first_call_s", c)
        for name, r in res.items():
            med = float(np.median(r["times"])) / args.steps
            r["step_ms"] = med * 1e3
            r["samples_per_s"] = m * n / med
            print(f"{family} M={m} N={n} {name}: step {med * 1e3:.4f} ms  "
                  f"{m * n / med:.4e} samples/s  spread "
                  f"{(max(r['times']) - min(r['times'])) / min(r['times']):.3f}"
                  f"  loss_err {r['loss_rel_err']:.2e}  "
                  f"grad_err {r['grad_rel_err']:.2e}", flush=True)
        out.append({"family": family, "m": m, "n": n, "routes": res})
        del data, runs
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
