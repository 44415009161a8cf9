"""Batch fitting of many materials at once.

The reference loops over MERL files one at a time
(examples/merl_params.cpp:53-68); here the whole 100-material MERL
set sits in device memory (100 x 17.5 MB) and fits *in parallel*: material
tables stack on a leading axis, the LSQ fit vmaps over it, and the
material axis shards across the mesh — the data-parallel "train on
all materials" path of BASELINE.json config 4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from dj_brdf_tpu import fresnel as fresnel_mod
from dj_brdf_tpu.core.math import from_spherical
from dj_brdf_tpu.fit import lsq
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.ndf import GGX
from dj_brdf_tpu.models.merl import Merl
from dj_brdf_tpu.parallel.mesh import DATA_AXIS


def sample_direction_set(key, n: int):
    """A shared quasi-random direction set for fitting targets."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    i = from_spherical(jax.random.uniform(k1, (n,), minval=0.03, maxval=1.5),
                       jax.random.uniform(k2, (n,), maxval=2 * jnp.pi))
    o = from_spherical(jax.random.uniform(k3, (n,), minval=0.03, maxval=1.5),
                       jax.random.uniform(k4, (n,), maxval=2 * jnp.pi))
    return i, o


def merl_targets(tables, i, o):
    """Evaluate a stack of MERL tables at the direction set:
    (M, 3, 90, 90, 180) -> (M, N, 3)."""
    def one(table):
        return Merl(table=table).evalp(i, o)
    return jax.vmap(one)(tables)


def tabulate_merl_batch(tables, res: int = 90, shadow: bool = True,
                        mesh=None):
    """Run the full tabulation pipeline (dj_brdf.h:2215-2236) on a
    *stack* of MERL tables in one vmapped device program — the device
    form of the reference's per-file loop in examples/merl_params.cpp:
    53-68. Returns ``(Tabular stack, fresnel points stack (M, res, 3),
    beckmann alphas (M,), ggx alphas (M,))``.

    The kernel build and table stages vmap over the material axis;
    only the 4-step power iteration hops to the host (float64, like
    the reference's ``matrix`` class — a (M, 89, 89) batched matvec).
    With a mesh, the material axis shards across devices (independent
    per-material work, zero communication)."""
    import numpy as np
    from dj_brdf_tpu.fit import moments, tabular as T
    from dj_brdf_tpu.microfacet.ndf import Tabular

    tables = jnp.asarray(tables)
    m = tables.shape[0]
    eval_fn = (lambda model, i, o: model.eval(i, o))

    pad = 0
    if mesh is not None:
        d = mesh.devices.size
        pad = (-m) % d
        if pad:
            tables = jnp.concatenate(
                [tables, tables[jnp.arange(pad) % m]], axis=0)
        tables = jax.device_put(
            tables, NamedSharding(mesh, P(DATA_AXIS)))

    def stage1(table):
        return T._kernel_matrix(eval_fn, Merl(table=table), res)

    def stage2(table, p22_raw):
        p22 = T.normalize_p22(p22_raw)
        sigma = T.compute_sigma(p22)
        fres_pts = T._fresnel_points(eval_fn, Merl(table=table), p22,
                                     sigma, res, shadow)
        cdf = T.compute_cdf(p22)
        qf = T.compute_qf(cdf)
        dist = Tabular(p22=p22, sigma=sigma, cdf=cdf, qf=qf)
        ab = moments.fit_beckmann_parameters(dist).ax
        ag = moments.fit_ggx_parameters(dist).ax
        return p22, sigma, cdf, qf, fres_pts, ab, ag

    K = jax.jit(jax.vmap(stage1))(tables)          # (M, cnt, cnt)

    # batched host-f64 power iteration (reference matrix::eigenvector,
    # dj_brdf.h:2467-2480, + the 1e-2 scale / trailing zero of :2517)
    import jax as _jax
    A = np.asarray(_jax.device_get(K), np.float64)
    v = np.ones(A.shape[:2], np.float64)
    for _ in range(4):
        v = np.einsum("mij,mj->mi", A, v)
    p22_raw = np.concatenate([1e-2 * v, np.zeros((A.shape[0], 1))], axis=1)
    p22_raw = jnp.asarray(p22_raw, tables.dtype)
    if mesh is not None:
        p22_raw = jax.device_put(p22_raw, NamedSharding(mesh, P(DATA_AXIS)))

    p22, sigma, cdf, qf, fres_pts, ab, ag = \
        jax.jit(jax.vmap(stage2))(tables, p22_raw)
    if pad:
        p22, sigma, cdf, qf, fres_pts, ab, ag = jax.tree_util.tree_map(
            lambda x: x[:m], (p22, sigma, cdf, qf, fres_pts, ab, ag))
    dists = Tabular(p22=p22, sigma=sigma, cdf=cdf, qf=qf)
    return dists, fres_pts, ab, ag


def make_batched_value_and_grad(targets, i, o, dist=GGX(),
                                route: str = "xla"):
    """The per-material fit step of :func:`fit_materials`: returns
    ``(value_and_grad, data)`` with ``value_and_grad(raw, *data) ->
    (per-material losses (M,), grad of their mean w.r.t. raw)``.

    ``route`` (``fit.lsq.adjoint_route``): "kernel" runs the hand
    adjoint as the Pallas kernel, which reads each direction block once
    for all materials; "xla" as the vmapped plain-XLA adjoint;
    "autodiff" as layered autodiff of ``fit.lsq.make_loss``."""
    from dj_brdf_tpu.ops import soa
    from dj_brdf_tpu.ops.fused_fit import lsq_value_and_grad_batched

    m = targets.shape[0]
    if route == "autodiff":
        loss_one = lsq.make_loss(dist)

        def vg(raw, i, o, targets):
            def loss_batched(raw):
                per_mat = jax.vmap(
                    lambda r, t: loss_one(r, i, o, t))(raw, targets)
                return jnp.mean(per_mat), per_mat

            (_, per_mat), grads = jax.value_and_grad(
                loss_batched, has_aux=True)(raw)
            return per_mat, grads

        return vg, (i, o, targets)

    family = lsq.fused_eligible(dist)
    fwdbwd = (soa.beckmann_lsq_fwdbwd_soa if family == "beck"
              else soa.ggx_lsq_fwdbwd_soa)
    comp = soa.split_dirs(i, o)
    tg3 = (targets[..., 0], targets[..., 1], targets[..., 2])  # (M, N)
    n = comp[0].size

    def vg(raw, *data):
        pvecs, vjp = jax.vjp(jax.vmap(soa.raw_to_pvec), raw)
        if route == "kernel":
            sums, gsums = lsq_value_and_grad_batched(pvecs, *data,
                                                     family=family)
        else:
            sums, gsums = jax.vmap(
                lambda pv, tr, tg, tb: fwdbwd(
                    pv, *data[:6], tr, tg, tb))(pvecs, *data[6:])
        (graw,) = vjp(gsums / (n * m))
        return sums / n, graw

    return vg, (*comp, *tg3)


def fit_materials(targets, i, o, steps: int = 300, lr: float = 5e-2,
                  mesh=None, dist=GGX(), fused: str = "auto"):
    """Fit per-material (MicrofacetParams, Schlick) to ``targets``
    (M, N, 3). With a mesh, the material axis shards across devices
    (fully independent fits — zero communication; the mesh turns 100
    sequential CPU fits into M/D per device).

    ``fused="auto"`` routes GGX-family and Beckmann fits through the
    hand-written adjoint (``fit.lsq.adjoint_route``: on an unsharded
    GPU the Pallas kernel, plain XLA elsewhere or under a mesh); "never"
    keeps the layered autodiff path."""
    route = lsq.adjoint_route(dist, fused=fused, sharded=mesh is not None)
    m = targets.shape[0]
    raw0 = jax.vmap(lambda _: lsq.raw_init())(jnp.arange(m))
    opt = optax.adam(lr)
    vg, data = make_batched_value_and_grad(targets, i, o, dist, route)

    @jax.jit
    def run(raw, *data):
        opt_state = opt.init(raw)

        def step(carry, _):
            raw, opt_state = carry
            per_mat, grads = vg(raw, *data)
            updates, opt_state = opt.update(grads, opt_state)
            raw = optax.apply_updates(raw, updates)
            return (raw, opt_state), per_mat

        (raw, _), per_mat = jax.lax.scan(step, (raw, opt_state), None,
                                         length=steps)
        return raw, per_mat[-1]

    if mesh is not None:
        # material-axis leaves shard; the shared direction set
        # replicates
        mat_sharding = NamedSharding(mesh, P(DATA_AXIS))
        data = tuple(a if a is i or a is o or a.ndim == 1
                     else jax.device_put(a, mat_sharding) for a in data)
        raw0 = jax.device_put(raw0, mat_sharding)

    raw, final_losses = run(raw0, *data)
    params, fres = jax.vmap(lsq.raw_to_model)(raw)
    return params, fres, final_losses
