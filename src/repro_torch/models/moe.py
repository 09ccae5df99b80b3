"""Mixture-of-Experts block (port of ``repro/models/moe.py``):
llama4-scout (16 experts top-1 + a shared expert) and deepseek-v2 (160
experts top-6 + 2 shared).

Capacity-based dispatch, as the reference's (GShard/Switch style): each
token is routed to its top-k experts by an f32 softmax router, each
(token, slot) pair takes the next free position of its expert's capacity
buffer (a cumulative sum over the row-major ``(T·k, E)`` one-hot), pairs
past the capacity are dropped (gate 0), the buffer ``(E, C, D)`` goes
through the experts as one batched product per projection, and the
outputs are gathered back, weighted by the renormalised gates in f32.

Every activation carries the port's leading node axis N (``x`` is
``(N, B, S, D)``, every weight ``(N, ...)``), and **each node routes and
drops its own tokens**: the capacity is sized from one node's
``t = B·S``, never from the fleet's, and the buffer is ``(N, E, C, D)``.
The expert products are ``torch.bmm`` over the N·E experts of the fleet
(the reference computes them as ``jnp.einsum`` outside any Pallas
kernel); the router, scatter and gather are plain PyTorch.

The block runs under ``torch.func.vmap`` (the train step's per-node
``grad_and_value``): the buffer is filled out of place, and nothing reads
a tensor's value on the host — the capacity depends on shapes only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models.layers import (
    _gelu,
    dense_init_on_device,
    mlp_apply,
    mlp_init,
)

__all__ = ["moe_init", "moe_apply", "capacity", "route", "dispatch",
           "expert_ffn", "combine", "Routing"]


def moe_init(generator, cfg, dtype, layers: int):
    """Stacked ``(layers, ...)`` MoE weights drawn on the generator's
    device: the f32 ``router`` ``(d, E)`` (fan-in d), the experts
    ``wg``/``wi`` ``(E, d, fe)`` and ``wo`` ``(E, fe, d)`` (``wi``, ``wo``
    only for a plain MLP), and the ``shared`` MLP of width
    ``fe · n_shared_experts`` when the config has shared experts.

    The experts' distribution is the reference's, quirk included: it
    draws them with ``dense_init(key, (E, d, fe))``, whose fan-in is
    ``shape[0]``, so their std is 1/√E, not 1/√d (ROADMAP Queue 3)."""
    d, fe, e = cfg.d_model, cfg.moe_d_ff_, cfg.n_experts
    init = lambda shape, dt: dense_init_on_device(
        generator, (layers,) + shape, dt, stacked=1)
    names = (("wg", "wi", "wo") if cfg.mlp_kind in ("swiglu", "geglu")
             else ("wi", "wo"))
    shapes = {"wg": (e, d, fe), "wi": (e, d, fe), "wo": (e, fe, d)}
    p = {"router": init((d, e), torch.float32),
         "experts": {name: init(shapes[name], dtype) for name in names}}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, d, fe * cfg.n_shared_experts,
                               cfg.mlp_kind, dtype, layers)
    return p


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens of ONE node: the reference's
    ``int(max(1, round(t·k/E·capacity_factor)))`` (Python's ``round``,
    ties to even), rounded up to a multiple of 128 above 128."""
    cap = int(max(1, round(t * cfg.experts_per_token / cfg.n_experts
                           * cfg.capacity_factor)))
    return (cap + 127) // 128 * 128 if cap > 128 else cap


class Routing(NamedTuple):
    """One node-stacked routing decision: ``gates`` ``(N, T, k)`` f32 (0
    for a dropped pair), ``expert_ids`` and ``slot`` ``(N, T, k)`` int64
    (the slot clipped to ``cap − 1``), ``keep`` ``(N, T, k)`` bool, the
    aux loss ``(N,)`` f32 and ``cap``."""
    gates: torch.Tensor
    expert_ids: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    cap: int


def route(p, cfg, tokens: torch.Tensor) -> Routing:
    """Router, top-k and capacity positions of every node's tokens
    ``(N, T, D)``.

    f32 logits ``tokens @ router`` and softmax; the top k in
    ``jax.lax.top_k``'s order (descending, ties to the lower expert: a
    stable sort); the gates renormalised over k.  The aux loss (Switch
    §2.2) is per node and takes the density from the first choice only,
    as the reference's.  Positions: a cumulative sum over the row-major
    ``(T·k, E)`` one-hot, so token t's slot j comes after every earlier
    token's slots and its own slots before j."""
    n, t, _ = tokens.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, t)
    logits = torch.bmm(tokens.float(), p["router"])             # (N, T, E)
    probs = torch.softmax(logits, dim=-1)
    top, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, expert_ids = top[..., :k], expert_ids[..., :k]          # (N, T, k)
    gates = top / top.sum(-1, keepdim=True)

    experts = torch.arange(e, device=tokens.device)
    first = (expert_ids[..., 0:1] == experts).float()            # (N, T, E)
    aux = (first.mean(1) * probs.mean(1)).sum(-1) * e * cfg.router_aux_loss

    onehot = (expert_ids[..., None] == experts).long()           # (N, T, k, E)
    flat = onehot.reshape(n, t * k, e)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).amax(-1)       # (N, T·k)
    pos = pos.reshape(n, t, k)
    keep = pos < cap
    return Routing(gates * keep, expert_ids, pos.clamp(0, cap - 1), keep,
                   aux, cap)


def _flat_index(r: Routing, e: int) -> torch.Tensor:
    """Each (token, slot) pair's row in the fleet's ``(N·E·C, D)`` buffer,
    ``(N·T·k,)``."""
    n = r.expert_ids.shape[0]
    node = torch.arange(n, device=r.slot.device)[:, None, None]
    return ((node * e + r.expert_ids) * r.cap + r.slot).reshape(-1)


def dispatch(r: Routing, tokens: torch.Tensor, e: int) -> torch.Tensor:
    """Scatter the tokens ``(N, T, D)`` into the ``(N, E, C, D)`` buffer
    in their type: each (token, slot) pair adds its token, or zeros when
    dropped, at its clipped slot (kept pairs never share a slot, so the
    adds are exact).  Out of place, so it runs under ``vmap``."""
    n, t, d = tokens.shape
    k = r.expert_ids.shape[-1]
    src = (tokens[:, :, None, :] * r.keep[..., None].to(tokens.dtype))
    buf = tokens.new_zeros((n * e * r.cap, d)).index_add(
        0, _flat_index(r, e), src.reshape(n * t * k, d))
    return buf.reshape(n, e, r.cap, d)


def expert_ffn(experts, buf: torch.Tensor, kind: str) -> torch.Tensor:
    """The grouped expert MLP: ``buf`` ``(N, E, C, D)`` with experts
    ``(N, E, D, fe)`` / ``(N, E, fe, D)`` → ``(N, E, C, D)``, one
    ``torch.bmm`` over the N·E experts per projection."""
    n, e, c, d = buf.shape
    x = buf.reshape(n * e, c, d)
    mm = lambda a, w: torch.bmm(a, w.reshape((n * e,) + w.shape[2:]))
    if kind in ("swiglu", "geglu"):
        act = torch.nn.functional.silu if kind == "swiglu" else _gelu
        h = act(mm(x, experts["wg"])) * mm(x, experts["wi"])
    else:
        h = _gelu(mm(x, experts["wi"]))
    return mm(h, experts["wo"]).reshape(n, e, c, d)


def combine(r: Routing, out_buf: torch.Tensor, dtype) -> torch.Tensor:
    """Gather each (token, slot) pair's expert output and sum over k
    weighted by its gate, in f32, then cast to ``dtype``: ``(N, T, D)``."""
    n, e, c, d = out_buf.shape
    t, k = r.expert_ids.shape[1:]
    rows = out_buf.reshape(n * e * c, d).index_select(0, _flat_index(r, e))
    out = (rows.float().reshape(n, t, k, d) * r.gates[..., None]).sum(2)
    return out.to(dtype)


def moe_apply(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(N, B, S, D)`` → (out ``(N, B, S, D)``, aux ``(N,)``): the
    routed experts' gate-weighted sum plus the shared experts."""
    n, b, s, d = x.shape
    tokens = x.reshape(n, b * s, d)
    r = route(p, cfg, tokens)
    buf = dispatch(r, tokens, cfg.n_experts)
    out_buf = expert_ffn(p["experts"], buf, cfg.mlp_kind)
    out = combine(r, out_buf, x.dtype).reshape(n, b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg.mlp_kind)
    return out, r.aux
