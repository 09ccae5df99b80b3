"""Optimizers over the stacked node axis (port of
``repro/training/optimizer.py``: ``sgd``, ``adam``, ``apply_updates``,
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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, TypedDict

import torch

from repro_torch import tree as tree_util

__all__ = [
    "Optimizer",
    "sgd",
    "adam",
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


def _f32_zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step_zeros(params) -> torch.Tensor:
    leaf = tree_util.leaves(params)[0]
    return torch.zeros((leaf.shape[0],), dtype=torch.int32,
                       device=leaf.device)


def _per_node(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) ``v`` shaped to broadcast against a stacked leaf ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def sgd(lr: float, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    """Plain SGD (+ momentum); updates in f32."""
    lr = float(lr)

    def init(params):
        mom = tree_util.tree_map(_f32_zeros, params) if momentum > 0.0 \
            else None
        return {"momentum": mom, "step": _step_zeros(params)}

    def update(grads, state, params=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        if momentum > 0.0:
            new_m = tree_util.tree_map(
                lambda m, g: momentum * m + g.to(torch.float32),
                state["momentum"], grads)
            updates = tree_util.tree_map(lambda m: -lr * m, new_m)
            return updates, {"momentum": new_m, "step": state["step"] + 1}
        updates = tree_util.tree_map(lambda g: -lr * g.to(torch.float32),
                                     grads)
        return updates, {"momentum": None, "step": state["step"] + 1}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         clip_norm: Optional[float] = None) -> Optimizer:
    """Adam with bias correction computed in f32, as the reference does
    (``b ** step`` on an f32 step)."""
    lr = float(lr)

    def init(params):
        return {"mu": tree_util.tree_map(_f32_zeros, params),
                "nu": tree_util.tree_map(_f32_zeros, params),
                "step": _step_zeros(params)}

    def update(grads, state, params=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        mu = tree_util.tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
            state["mu"], grads)
        nu = tree_util.tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state["nu"], grads)
        s = step.to(torch.float32)
        f32 = dict(dtype=torch.float32, device=s.device)
        mu_hat = 1.0 / (1.0 - torch.tensor(b1, **f32) ** s)
        nu_hat = 1.0 / (1.0 - torch.tensor(b2, **f32) ** s)
        updates = tree_util.tree_map(
            lambda m, v: -lr * (m * _per_node(mu_hat, m))
            / (torch.sqrt(v * _per_node(nu_hat, v)) + eps), mu, nu)
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


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
