"""Serving: full-sequence prefill, chunked prefill and cached decode over
the stacked node models (port of ``repro/serving/serve_step.py``).

Each node serves inference from its OWN model (the paper's setting has no
global model), so serving keeps the node axis: requests ``(N, B, ...)``
decode in lockstep against params ``(N, ...)``.  The reference ``vmap``s
one node's step over N; the port's model functions take the node axis
written out (``models.transformer.forward_nodes`` /
``decode_step_nodes``), so one call serves the fleet.

* :func:`make_forward_prefill` — full-sequence forward, last-position
  logits only (the ``prefill_32k`` surface).  With
  ``ForwardOptions(attn_impl="pallas")`` it makes one flash-attention
  launch per layer for the whole fleet, the node axis folded into the
  batch; for the ``ssm`` family ``ForwardOptions(use_ssm_kernel=True)``
  makes one RWKV-6 scan launch per layer the same way.
* :func:`make_prefill_step` — chunked prefill through the decode path:
  one call advances up to C tokens per slot with per-slot valid lengths.
  Lanes whose planned tokens run out *self-feed* their own greedy sample;
  slots whose ``lens`` entry is 0 are frozen bit-exactly, ``position``
  included.

The fleet variants (:func:`make_fleet_decode_step`,
:func:`make_fleet_prefill_step`) are fed by the ``(n, P)`` parameter
plane: ``PlaneLayout.unpack`` hands out views of the plane each step, so
a model swap (a plane row write) is seen by the next step.  Eager PyTorch
has no traced program to re-enter; the reference's retrace counters have
no counterpart.

Sampling is greedy, except in :func:`greedy_generate` given a temperature
and a key, which draws from the reference's ``jax.random.categorical``
stream (``core.prng.categorical``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.plane import PlaneLayout
from repro_torch.models.transformer import (
    STATE_LEAVES,
    ForwardOptions,
    add_node_axis,
    decode_step,
    decode_step_nodes,
    drop_node_axis,
    forward_nodes,
    init_cache,
    unembed_nodes,
)

__all__ = [
    "make_forward_prefill",
    "make_prefill_step",
    "make_serve_step",
    "make_fleet_decode_step",
    "make_fleet_prefill_step",
    "make_cache",
    "reset_slots",
    "greedy_generate",
]


def make_forward_prefill(cfg: ModelConfig,
                         opts: Optional[ForwardOptions] = None,
                         last_only: bool = True):
    """prefill(params (N, ...), batch {"tokens": (N, B, S)} or, for a
    frontend config, {"embeddings": (N, B, S, F)}) → logits.

    ``last_only`` unembeds only the final position — ``(N, B, V)`` — which
    is what serving needs (the first sampled token)."""
    opts = opts or ForwardOptions()

    def prefill(stacked_params, batch):
        tokens = (batch["embeddings"] if "embeddings" in batch
                  else batch["tokens"])
        if last_only:
            hidden, _ = forward_nodes(stacked_params, cfg, tokens, opts,
                                      return_hidden=True)
            return unembed_nodes(stacked_params, cfg, hidden[:, :, -1:])[:, :, 0]
        logits, _ = forward_nodes(stacked_params, cfg, tokens, opts)
        return logits

    return prefill


def _slot_mask(valid: torch.Tensor, key: str, ref: torch.Tensor):
    """Broadcast an ``(N, B)`` validity mask against a node-stacked cache
    leaf: ``position`` is ``(N, B)``; K/V, MLA's latents and every state
    leaf (RWKV's, and the hybrid family's ``ssm_state`` ``(N, L, B, di,
    n)`` and ``conv_state`` ``(N, L, B, kdim − 1, di)``) are ``(N, L, B,
    ...)``."""
    if key == "position":
        return valid
    n, b = valid.shape
    return valid.reshape((n, 1, b) + (1,) * (ref.ndim - 3))


def _prefill_nodes(params, cfg: ModelConfig, toks, feed, lens, cache,
                   opts: Optional[ForwardOptions] = None):
    """The chunked self-feeding prefill for every node: toks
    ``(N, B, C)``, feed/lens ``(N, B)``, node-stacked cache →
    (last_logits ``(N, B, V)``, sampled ``(N, B, C)``, cache).  Step t
    feeds ``toks[..., t]`` while ``t < feed``, else the lane's own last
    sample; a lane takes part while ``t < lens``."""
    n, b, c = toks.shape
    last = torch.zeros((n, b, cfg.vocab_size), dtype=torch.float32,
                       device=toks.device)
    prev = torch.zeros((n, b), dtype=toks.dtype, device=toks.device)
    samples = []
    for t in range(c):
        tok = torch.where(t < feed, toks[..., t], prev)
        logits, stepped = decode_step_nodes(params, cfg, tok[..., None], cache,
                                            opts)
        valid = t < lens
        cache = {k: torch.where(_slot_mask(valid, k, v), v, cache[k])
                 for k, v in stepped.items()}
        step_logits = logits[:, :, 0]
        samp = torch.argmax(step_logits, dim=-1).to(toks.dtype)
        prev = torch.where(valid, samp, prev)
        last = torch.where(valid[..., None], step_logits.float(), last)
        samples.append(samp)
    return last, torch.stack(samples, dim=-1), cache


def make_prefill_step(cfg: ModelConfig,
                      opts: Optional[ForwardOptions] = None):
    """Chunked prefill with self-feeding decode lanes for ONE node:
    prefill(params, toks (B, C), feed (B,), lens (B,), cache) →
    (last_logits (B, V), sampled (B, C), cache).

    Per step t, slot b takes part iff ``t < lens[b]``; its input token is
    ``toks[b, t]`` while ``t < feed[b]`` and its own previous greedy
    sample after that.  Frozen slots (``lens[b] = 0``) keep their cache
    leaves, ``position`` included, bit-exactly; ``last_logits[b]`` is the
    logits row of slot b's final valid step (zeros where ``lens[b] = 0``).
    """
    def prefill(params, toks, feed, lens, cache):
        last, sampled, cache = _prefill_nodes(
            add_node_axis(params), cfg, toks[None], feed[None], lens[None],
            add_node_axis(cache), opts)
        return last[0], sampled[0], drop_node_axis(cache)

    return prefill


def make_cache(cfg: ModelConfig, n_nodes: int, batch_per_node: int,
               max_seq: int, device=None):
    """Node-stacked decode cache: ``position`` ``(N, B)``, K/V
    ``(N, L, B, T, KV, hd)`` (``ssm``: ``rwkv_state``
    ``(N, L, B, H, hd, hd)``, ``tm_prev``/``cm_prev`` ``(N, L, B, D)``;
    hybrid: K/V, ``ssm_state`` ``(N, L, B, di, n)`` and ``conv_state``
    ``(N, L, B, kdim − 1, di)``)."""
    one = init_cache(cfg, batch_per_node, max_seq, device)
    return tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.ndim), one)


def reset_slots(cache, fresh: torch.Tensor):
    """Admission into the slots where ``fresh`` ``(N, B)`` is True: their
    ``position`` ← 0 and every leaf that carries state from token to
    token (``STATE_LEAVES``: RWKV's state and carries, the hybrid
    family's Mamba state and conv inputs) ← 0, so a request never
    inherits the previous occupant's recurrent state.  K/V leaves are left alone: the
    mask hides entries past ``position``."""
    return {k: (v.masked_fill(_slot_mask(fresh, k, v), 0)
                if k == "position" or k in STATE_LEAVES else v)
            for k, v in cache.items()}


def make_serve_step(cfg: ModelConfig, opts: Optional[ForwardOptions] = None):
    """serve_step(params (N, ...), tokens (N, B, 1), cache (N, ...)) →
    (logits (N, B, 1, V), new cache)."""
    def serve(stacked_params, tokens, cache):
        return decode_step_nodes(stacked_params, cfg, tokens, cache, opts)

    return serve


def make_fleet_decode_step(cfg: ModelConfig, layout: PlaneLayout,
                           opts: Optional[ForwardOptions] = None):
    """fleet_decode(plane (n, P), tokens (n, B, 1), cache (n, ...)) →
    (logits (n, B, 1, V), new cache): one step for the fleet, the params
    unpacked as views of the plane."""
    def fleet(plane, tokens, cache):
        return decode_step_nodes(layout.unpack(plane), cfg, tokens, cache,
                                 opts)

    return fleet


def make_fleet_prefill_step(cfg: ModelConfig, layout: PlaneLayout,
                            opts: Optional[ForwardOptions] = None):
    """fleet_prefill(plane (n, P), toks (n, B, C), feed (n, B),
    lens (n, B), cache (n, ...)) → (last_logits (n, B, V), sampled
    (n, B, C), new cache): the self-feeding chunked prefill for the fleet,
    plane-fed like :func:`make_fleet_decode_step`."""
    def fleet(plane, toks, feed, lens, cache):
        return _prefill_nodes(layout.unpack(plane), cfg, toks, feed, lens,
                              cache, opts)

    return fleet


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    n_new: int, max_seq: Optional[int] = None,
                    temperature: float = 0.0, rng=None) -> torch.Tensor:
    """Single-node generator: prompt ``(B, S0)`` → ``(B, S0 + n_new)``,
    the prompt fed token by token through the decode path.  Greedy, unless
    given both ``temperature > 0`` and ``rng`` (a ``core.prng`` key, the
    reference's ``jax.random`` key data): each new token is then drawn as
    the reference draws it, ``rng, sub = split(rng)`` and
    ``categorical(sub, logits / temperature)``."""
    b, s0 = prompt.shape
    max_seq = max_seq or (s0 + n_new)
    cache = init_cache(cfg, b, max_seq, device=prompt.device)
    tokens = prompt
    logits = None
    for i in range(s0):
        logits, cache = decode_step(params, cfg, prompt[:, i:i + 1], cache)
    for _ in range(n_new):
        if temperature > 0.0 and rng is not None:
            rng, sub = prng.split(rng)
            nxt = prng.categorical(sub, logits[:, -1] / temperature)
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        nxt = nxt[:, None].to(prompt.dtype)
        tokens = torch.cat([tokens, nxt], dim=1)
        logits, cache = decode_step(params, cfg, nxt, cache)
    return tokens
