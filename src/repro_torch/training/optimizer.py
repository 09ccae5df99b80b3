"""Optimizers over the stacked node axis (port of
``repro/training/optimizer.py``: ``sgd``, ``adam``, ``adamw``,
``make_optimizer``, the learning-rate schedules, ``apply_updates``,
``clip_by_global_norm`` and the nonfinite guard ``skip_nonfinite_updates``).

The reference's ``Optimizer`` updates ONE node and the trainer vmaps it
over the node axis.  The port writes that axis out: every tree here has
leaves ``(n, ...)``, and every per-node quantity stays per node.  In
particular :func:`global_norm` is one norm per node — the reference
computes it under ``vmap``, so a norm taken over the stacked tensors would
be wrong.  The step counter too is one int32 per node, ``(n,)``, as in
the reference's vmapped state, so a round with partial participation can
keep an inactive node's count.  States are dicts of trees so they flatten
in ``jax.tree`` order.  A tree may also carry the sweep engine's
experiments folded into its node axis (``(E·n, ...)``): every quantity
stays per row.

A learning rate is a float or a schedule, ``step -> rate``, evaluated on
the ``(n,)`` int32 step vector (the step before the update, as the
reference's) into an ``(n,)`` f32 rate with the reference's f32
arithmetic; a float keeps the f32 scalar multiply of the reference's
constant schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, TypedDict, Union

import numpy as np
import torch

from repro_torch import to_device
from repro_torch import tree as tree_util

__all__ = [
    "Optimizer",
    "sgd",
    "adam",
    "adamw",
    "constant_schedule",
    "cosine_schedule",
    "warmup_cosine_schedule",
    "make_optimizer",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "NonfiniteGuardState",
    "skip_nonfinite_updates",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable     # stacked params -> state
    update: Callable   # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_util.tree_map(lambda p, u: (p + u).to(p.dtype), params,
                              updates)


def global_norm(tree) -> torch.Tensor:
    """(n,) per-node L2 norm over every leaf of a stacked tree (f32)."""
    sq = [torch.square(x.to(torch.float32)).reshape(x.shape[0], -1).sum(1)
          for x in tree_util.leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum(0))


def clip_by_global_norm(tree, max_norm: float):
    """Scale each node's leaves so that node's global norm is at most
    ``max_norm``; returns ``(clipped tree, (n,) norms)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)

    def clip(x):
        return x * scale.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)

    return tree_util.tree_map(clip, tree), norm


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------
Schedule = Callable[[torch.Tensor], Union[float, torch.Tensor]]
_PI_F32 = float(np.float32(math.pi))   # jnp.pi as a weak f32 scalar


def constant_schedule(lr: float) -> Schedule:
    """The same rate at every step, as an f32 scalar (a Python float that
    every multiply rounds to f32)."""
    rate = float(np.float32(lr))
    return lambda step: rate


def cosine_schedule(lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Schedule:
    """``lr · (final_frac + (1 − final_frac) · ½(1 + cos(π t)))`` with
    ``t = min(step, total) / total``, all in f32."""
    def fn(step):
        t = torch.clamp(step, max=total_steps).to(torch.float32) \
            / float(max(total_steps, 1))
        cos = 0.5 * (1.0 + torch.cos(_PI_F32 * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def warmup_cosine_schedule(lr: float, warmup: int, total_steps: int,
                           final_frac: float = 0.1) -> Schedule:
    """A linear warmup to ``lr`` over ``warmup`` steps (``lr · (step + 1)
    / warmup``), then :func:`cosine_schedule` over the rest."""
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        warm = lr * (step + 1).to(torch.float32) / float(max(warmup, 1))
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(float(lr))


def _scaled(eta, x: torch.Tensor) -> Union[float, torch.Tensor]:
    """A rate (an f32 scalar, or ``(n,)``) shaped to scale a stacked leaf."""
    return eta if isinstance(eta, float) else _per_node(eta, x)


def _f32_product(a, b):
    """``a · b`` rounded to f32, a rate being a float or a tensor."""
    if isinstance(a, float):
        return float(np.float32(a) * np.float32(b))
    return a * b


def _f32_zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step_zeros(params) -> torch.Tensor:
    leaf = tree_util.leaves(params)[0]
    return torch.zeros((leaf.shape[0],), dtype=torch.int32,
                       device=leaf.device)


def _per_node(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) ``v`` shaped to broadcast against a stacked leaf ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def sgd(lr, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    """Plain SGD (+ momentum); updates in f32.  ``lr`` a float or a
    schedule."""
    sched = _as_schedule(lr)

    def init(params):
        mom = tree_util.tree_map(_f32_zeros, params) if momentum > 0.0 \
            else None
        return {"momentum": mom, "step": _step_zeros(params)}

    def update(grads, state, params=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        eta = sched(state["step"])
        if momentum > 0.0:
            new_m = tree_util.tree_map(
                lambda m, g: momentum * m + g.to(torch.float32),
                state["momentum"], grads)
            updates = tree_util.tree_map(lambda m: -_scaled(eta, m) * m,
                                         new_m)
            return updates, {"momentum": new_m, "step": state["step"] + 1}
        updates = tree_util.tree_map(
            lambda g: -_scaled(eta, g) * g.to(torch.float32), grads)
        return updates, {"momentum": None, "step": state["step"] + 1}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay, clip_norm) -> Optimizer:
    """Adam with bias correction computed in f32, as the reference does
    (``b ** step`` on an f32 step); ``weight_decay > 0`` subtracts
    ``eta · weight_decay · p`` after the Adam step (AdamW)."""
    sched = _as_schedule(lr)
    uploaded = {}

    def betas(device):
        """b1 and b2 as f32 tensors on ``device``, uploaded once through
        pinned memory: a tensor built on the card from a Python scalar
        is a pageable copy, which waits for the stream at every step."""
        if device not in uploaded:
            uploaded[device] = tuple(
                to_device(np.float32(b), device) for b in (b1, b2))
        return uploaded[device]

    def init(params):
        return {"mu": tree_util.tree_map(_f32_zeros, params),
                "nu": tree_util.tree_map(_f32_zeros, params),
                "step": _step_zeros(params)}

    def update(grads, state, params=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        if weight_decay > 0.0 and params is None:
            raise ValueError("adamw.update requires params for weight decay")
        step = state["step"] + 1
        eta = sched(state["step"])
        mu = tree_util.tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
            state["mu"], grads)
        nu = tree_util.tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state["nu"], grads)
        s = step.to(torch.float32)
        b1_t, b2_t = betas(s.device)
        mu_hat = 1.0 / (1.0 - b1_t ** s)
        nu_hat = 1.0 / (1.0 - b2_t ** s)

        def upd(m, v):
            return (-_scaled(eta, m) * (m * _per_node(mu_hat, m))
                    / (torch.sqrt(v * _per_node(nu_hat, v)) + eps))

        updates = tree_util.tree_map(upd, mu, nu)
        if weight_decay > 0.0:
            decay = _f32_product(eta, weight_decay)
            updates = tree_util.tree_map(
                lambda u, p: u - _scaled(decay, u) * p.to(torch.float32),
                updates, params)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         clip_norm: Optional[float] = None) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, clip_norm)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          clip_norm: Optional[float] = None) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, clip_norm)


# ----------------------------------------------------------------------
# nonfinite guard (DESIGN.md §16: the local half of fault tolerance)
# ----------------------------------------------------------------------
class NonfiniteGuardState(TypedDict):
    """The guard's state: the wrapped optimizer's state and ``skipped``,
    an ``(n,)`` int32 count of each node's dropped steps (the reference's
    NamedTuple fields, in the same flatten order)."""

    inner: Any
    skipped: torch.Tensor


def skip_nonfinite_updates(opt: Optimizer) -> Optimizer:
    """Wrap ``opt`` so a node's step with any NaN/Inf gradient is the
    identity for that node: its update is zero, its inner state (step
    count included) is carried through unchanged, and its ``skipped``
    count grows by one.  The gradients are zero-substituted before the
    inner update, so no NaN arithmetic leaks through the select.  Per
    node on the stacked axis, as the reference's guard is under its
    vmap."""

    def init(params):
        return NonfiniteGuardState(inner=opt.init(params),
                                   skipped=_step_zeros(params))

    def update(grads, state, params=None):
        leaves = tree_util.leaves(grads)
        n = leaves[0].shape[0]
        finite = torch.stack([torch.isfinite(g.reshape(n, -1)).all(dim=1)
                              for g in leaves]).all(dim=0)
        safe = tree_util.tree_map(
            lambda g: torch.where(_per_node(finite, g), g,
                                  torch.zeros_like(g)), grads)
        upd, new_inner = opt.update(safe, state["inner"], params)

        def sel(new, old):
            return torch.where(_per_node(finite, new), new, old)

        updates = tree_util.tree_map(
            lambda u: sel(u, torch.zeros_like(u)), upd)
        inner = tree_util.tree_map(sel, new_inner, state["inner"])
        skipped = torch.where(finite, state["skipped"],
                              state["skipped"] + 1)
        return updates, NonfiniteGuardState(inner=inner, skipped=skipped)

    return Optimizer(init, update)


def make_optimizer(name: str, lr, skip_nonfinite: bool = False,
                   **kwargs) -> Optimizer:
    """``sgd``, ``adam`` or ``adamw`` by name, optionally behind the
    nonfinite guard."""
    table = {"sgd": sgd, "adam": adam, "adamw": adamw}
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(table)}")
    opt = table[name](lr, **kwargs)
    return skip_nonfinite_updates(opt) if skip_nonfinite else opt
