"""Production train step (port of ``repro/training/train_step.py``):
microbatched gradient accumulation per node, the per-node optimizer
update over the stacked node axis, then the gossip mix.

One step, with leaves ``(N, ...)`` everywhere:

  1. per node: loop over the microbatches, accumulate f32 gradients
     (LocalTrain's inner loop), divide by ``pcfg.microbatch``;
  2. per node: the optimizer update (Eq. 1);
  3. gossip: the stacked params times the ``(N, N)`` mixing matrix
     (Eq. 2) through the fused-plane CUDA kernel over the packed
     ``(N, P)`` plane (``kernels.gossip_mix.mix_plane``; its plain
     version for CPU tensors).  The reference's ``mix_dense`` computes the
     same f32 sums leaf by leaf.

The reference checkpoints each layer (``pcfg.remat``) to shape its traced
program's memory; the port runs eagerly, keeps autograd's saved tensors,
and has no such knob.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.kernels.gossip_mix import mix_plane
from repro_torch.models.transformer import ForwardOptions
from repro_torch.training.losses import lm_loss_fn
from repro_torch.training.optimizer import (Optimizer, apply_updates,
                                            skip_nonfinite_updates)

__all__ = ["make_train_step", "make_loss", "reshape_for_microbatch"]


def make_loss(cfg: ModelConfig, pcfg: ParallelConfig,
              opts: Optional[ForwardOptions] = None):
    return lm_loss_fn(cfg, opts or ForwardOptions(),
                      chunked_ce=pcfg.chunked_ce)


def make_train_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    optimizer: Optimizer,
    opts: Optional[ForwardOptions] = None,
    gossip: bool = True,
    skip_nonfinite: bool = False,
) -> Callable:
    """Build ``train_step(params, opt_state, batch, coeffs) -> (params,
    opt_state, loss)`` with stacked node axes everywhere: batch leaves
    ``(N, micro, local_b, S)``, ``coeffs`` the ``(N, N)`` row-stochastic
    mixing matrix, ``loss`` the mean over nodes of each node's mean
    microbatch loss.

    ``skip_nonfinite=True`` wraps the optimizer in
    :func:`training.optimizer.skip_nonfinite_updates`; the state must then
    come from the wrapped optimizer's ``init``."""
    loss_fn = make_loss(cfg, pcfg, opts)
    if skip_nonfinite:
        optimizer = skip_nonfinite_updates(optimizer)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def train_step(stacked_params, stacked_opt, batch, coeffs):
        micro = tree_util.leaves(batch)[0].shape[1]
        acc = tree_util.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), stacked_params)
        loss_sum = 0.0
        for m in range(micro):
            mb = tree_util.tree_map(lambda x: x[:, m], batch)
            grads, loss = grad_fn(stacked_params, mb)
            acc = tree_util.tree_map(lambda a, g: a + g.to(torch.float32),
                                     acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_util.tree_map(lambda g: g / pcfg.microbatch, acc)
        losses = loss_sum / pcfg.microbatch
        updates, new_opt = optimizer.update(grads, stacked_opt,
                                            stacked_params)
        new_params = apply_updates(stacked_params, updates)
        if gossip:
            new_params = mix_plane(new_params, coeffs)
        return new_params, new_opt, losses.mean()

    return train_step


def reshape_for_microbatch(batch, n_nodes: int, micro: int):
    """``(global_b, S...)`` → ``(N, micro, local_b / micro, S...)``."""

    def fn(leaf):
        g = leaf.shape[0]
        local = g // n_nodes
        mb = local // micro
        if local % micro:
            raise ValueError(
                f"local batch {local} not divisible by microbatch {micro}")
        return leaf.reshape((n_nodes, micro, mb) + tuple(leaf.shape[1:]))

    return tree_util.tree_map(fn, batch)
