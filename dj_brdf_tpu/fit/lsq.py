"""Autodiff nonlinear least-squares BRDF fitting.

The reference extracts parameters by quadrature moments
(dj_brdf.h:3124-3307); this module is the framework's *new-capability*
fitting path (BASELINE.json north_star): fit microfacet parameters +
Fresnel directly to measured data by gradient descent on a
differentiable loss, data-parallel over a device mesh — per-shard
gradients are combined by jit's automatic psum when the sample batch
carries a sharding and the parameters are replicated.

The moment fits remain available in :mod:`dj_brdf_tpu.fit.moments` as
reference checks and good initializers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from dj_brdf_tpu import fresnel as fresnel_mod
from dj_brdf_tpu.microfacet import brdf as mf
from dj_brdf_tpu.microfacet.params import MicrofacetParams


class RawFit(NamedTuple):
    """Unconstrained parameterization of (MicrofacetParams, Schlick f0)."""
    log_ax: jnp.ndarray
    log_ay: jnp.ndarray
    raw_rho: jnp.ndarray
    txn: jnp.ndarray
    tyn: jnp.ndarray
    logit_f0: jnp.ndarray  # (3,)


def raw_init(alpha: float = 0.3, f0: float = 0.5) -> RawFit:
    a = jnp.log(jnp.asarray(alpha, jnp.float32))
    return RawFit(log_ax=a, log_ay=a,
                  raw_rho=jnp.zeros((), jnp.float32),
                  txn=jnp.zeros((), jnp.float32),
                  tyn=jnp.zeros((), jnp.float32),
                  logit_f0=jnp.full((3,), jnp.log(f0 / (1 - f0)), jnp.float32))


def raw_to_model(raw: RawFit):
    """Map unconstrained leaves to valid microfacet + fresnel params."""
    params = MicrofacetParams(
        ax=jnp.exp(raw.log_ax) + 1e-4,
        ay=jnp.exp(raw.log_ay) + 1e-4,
        rho=0.99 * jnp.tanh(raw.raw_rho),
        txn=raw.txn, tyn=raw.tyn)
    fres = fresnel_mod.Schlick(f0=jax.nn.sigmoid(raw.logit_f0))
    return params, fres


def relative_l2(pred, target, eps: float = 1e-2):
    """Relative squared error — standard for HDR BRDF fitting (keeps
    highlights from drowning out the falloff)."""
    return jnp.mean(((pred - target) / (target + eps)) ** 2)


def make_loss(dist, shadow: bool = True,
              loss_fn: Callable = relative_l2):
    def loss(raw: RawFit, i, o, target):
        params, fres = raw_to_model(raw)
        pred = mf.evalp(dist, fres, params, i, o, shadow)
        return loss_fn(pred, target)
    return loss


def fused_eligible(dist, shadow: bool = True):
    """The hand-adjoint family ("ggx" or "beck") when the fit shape
    matches one (ops/soa.py ``*_lsq_fwdbwd_soa``): GGX-family or
    Beckmann distribution, height-correlated Smith shadowing, the
    standard RawFit parameterization — the reference's co-equal fit
    pair (dj_brdf.h:3133-3184). None otherwise."""
    from dj_brdf_tpu.microfacet.ndf import GGX, Beckmann
    if not shadow:
        return None
    if isinstance(dist, GGX):
        return "ggx"
    if type(dist) is Beckmann:
        return "beck"
    return None


def adjoint_route(dist, shadow: bool = True, fused: str = "auto",
                  sharded: bool = False, platform: str | None = None):
    """Where a fit's loss and gradient run — the one routing rule for
    :func:`fit_lsq`, ``fit.batch.fit_materials`` and the benchmark.

    * ``"kernel"``: the Triton-route Pallas kernel
      (``ops/fused_fit.py``) — unsharded hand-adjoint fits on a GPU;
    * ``"xla"``: the same hand adjoint as plain XLA — other platforms,
      and sharded batches, where XLA partitions it and inserts the
      gradient psum (the kernel does not partition);
    * ``"autodiff"``: layered autodiff of :func:`make_loss` —
      ``fused="never"`` or a fit with no hand adjoint.

    ``platform`` defaults to ``jax.default_backend()``."""
    if fused not in ("auto", "never"):
        raise ValueError(f"fused must be auto|never, got {fused!r}")
    if fused == "never" or fused_eligible(dist, shadow) is None:
        return "autodiff"
    platform = platform or jax.default_backend()
    return "kernel" if platform == "gpu" and not sharded else "xla"


def make_fused_value_and_grad(i, o, target, family: str = "ggx",
                              route: str = "xla"):
    """Build the microfacet + Schlick fit step through the hand-written
    adjoint (hot chain dj_brdf.h:1529-1547): ``route="kernel"`` runs it
    as the Pallas kernel, ``"xla"`` as plain XLA
    (``soa.*_lsq_fwdbwd_soa``); see :func:`adjoint_route`. The
    8-scalar chain through ``raw_to_model`` is pulled back with one
    vjp.

    Returns ``(value_and_grad, data)`` where
    ``value_and_grad(raw, *data) -> (loss, grad_raw)`` and ``data`` is
    the 9-tuple of component arrays — pass it *through* your jit
    boundary so the batch stays a program argument, never a baked-in
    constant."""
    from dj_brdf_tpu.ops import fused_fit, soa

    if route not in ("kernel", "xla"):
        raise ValueError(f"route must be kernel|xla, got {route!r}")
    comp = soa.split_dirs(i, o)
    targets = (target[..., 0], target[..., 1], target[..., 2])
    n = comp[0].size
    fwdbwd = (soa.beckmann_lsq_fwdbwd_soa if family == "beck"
              else soa.ggx_lsq_fwdbwd_soa)

    def value_and_grad(raw: RawFit, *data):
        pvec, vjp = jax.vjp(soa.raw_to_pvec, raw)
        if route == "kernel":
            s, gs = fused_fit.lsq_value_and_grad_batched(
                pvec[None], *data[:6], *(t[None] for t in data[6:]),
                family=family)
            s, gs = s[0], gs[0]
        else:
            s, gs = fwdbwd(pvec, *data)
        (graw,) = vjp(gs / n)
        return s / n, graw

    return value_and_grad, (*comp, *targets)


def fit_lsq(dist, i, o, target, steps: int = 200, lr: float = 5e-2,
            init: RawFit | None = None, shadow: bool = True,
            in_shardings=None, fused: str = "auto"):
    """Fit (MicrofacetParams, Schlick) to ``target = evalp(i, o)``.

    ``in_shardings``: optional NamedSharding for the (i, o, target)
    batch — pass shardings over a mesh data axis to data-parallelize;
    gradients reduce over devices automatically.

    ``fused``: "auto" routes GGX-family and Beckmann fits through the
    hand-written adjoint (:func:`adjoint_route`: the Pallas kernel on a
    GPU, plain XLA elsewhere or when sharded); "never" forces the
    layered autodiff path (other distributions always use it).

    Returns (params, fresnel, losses)."""
    route = adjoint_route(dist, shadow, fused,
                          sharded=in_shardings is not None)
    raw = init if init is not None else raw_init()
    opt = optax.adam(lr)
    opt_state = opt.init(raw)

    if in_shardings is not None:
        i = jax.device_put(i, in_shardings)
        o = jax.device_put(o, in_shardings)
        target = jax.device_put(target, in_shardings)

    if route != "autodiff":
        vg, data = make_fused_value_and_grad(
            i, o, target, family=fused_eligible(dist, shadow), route=route)
    else:
        loss = make_loss(dist, shadow)

        def vg(raw, i, o, target):
            return jax.value_and_grad(loss)(raw, i, o, target)

        data = (i, o, target)

    @jax.jit
    def run(raw, opt_state, *data):
        def step(carry, _):
            raw, opt_state = carry
            val, grads = vg(raw, *data)
            updates, opt_state = opt.update(grads, opt_state)
            raw = optax.apply_updates(raw, updates)
            return (raw, opt_state), val

        (raw, opt_state), losses = jax.lax.scan(step, (raw, opt_state),
                                                None, length=steps)
        return raw, losses

    raw, losses = run(raw, opt_state, *data)
    params, fres = raw_to_model(raw)
    return params, fres, losses
