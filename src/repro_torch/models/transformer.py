"""Model assembly for every family of the zoo (port of
``repro/models/transformer.py``).

  dense     — [norm → GQA or MLA attention → +res] [norm → MLP → +res]  (× L)
  moe       — the same attention, then [norm → routed experts (+ shared)
              → +res]
  ssm       — [norm → RWKV-6 time-mix → +res] [norm → channel-mix → +res]
  hybrid    — attention and Mamba heads side by side on the same norm,
              their outputs averaged (hymba), then the MLP
  vlm/audio — the dense stack fed by the modality frontend's embeddings
              (``frontend_proj``) in place of token embeddings

The parameter tree is the reference's: ``embed``, ``final_norm``,
``head`` (unless tied), ``frontend_proj`` (frontend configs),
``dense_layers`` and, for a MoE config, ``moe_layers``, whose leaves are
stacked along a leading axis over their layers; a hybrid layer adds
``mamba`` (``models/ssm.py``).  A MoE config's first ``first_k_dense``
layers are dense (deepseek-v2: one) and the rest MoE layers, which hold
``moe`` (``models/moe.py``) where a dense layer holds ``mlp``; with
``first_k_dense = 0`` (llama4-scout) there is no ``dense_layers`` key.
The reference scans each group and ``vmap``s the fleet's node axis; the
port loops over the layers in Python and writes the node axis out:
:func:`forward_nodes` and :func:`decode_step_nodes` take every parameter
leaf with a leading node axis N (layer leaves are ``(N, L, ...)``) and
tokens ``(N, B, S)`` (or frontend embeddings ``(N, B, S, F)``), so a
fleet's prefill makes one attention call per layer for all its nodes,
while each node's MoE layer routes, and drops, its own tokens.
:func:`forward` and :func:`decode_step` are the reference's single-node
signatures, ``N = 1``.

Attention runs by ``ForwardOptions.attn_impl``: ``"einsum"`` (full
``(S, T)`` logits), ``"chunked"`` (the plain online-softmax scan) or
``"pallas"`` (the flash-attention CUDA kernel,
``kernels.flash_attention``, or for MLA configs the latent-attention
kernel, ``kernels.mla_attention``; the name is kept from the reference).
Decode is always the einsum path against the cache (K/V, or MLA's latent
``ckv`` and rope key ``kr``).  The RWKV-6 scan runs by
``ForwardOptions.use_ssm_kernel``: the RWKV-6 CUDA kernel
(``kernels.ssm_scan``, one launch per layer for the fleet) or the
reference's one-step scan body, which decode always runs
(``models/ssm.py``).  The Mamba recurrence is a plain loop over time
(the reference's is a ``lax.scan``, not a kernel).

The decode cache stays stacked over all L layers; decode takes each
layer's slice of it, whichever group the layer is in.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.layers import (
    attention_apply,
    attention_decode,
    attention_init,
    dense_init_on_device,
    mla_apply,
    mla_decode,
    mla_init,
    mlp_apply,
    mlp_init,
    node_matmul,
    norm_apply,
    norm_init,
    softcap,
)

__all__ = ["init_params", "forward", "forward_nodes", "init_cache",
           "decode_step", "decode_step_nodes", "unembed_nodes",
           "ForwardOptions", "ATTN_IMPLS", "SSM_STATE_LEAVES",
           "MAMBA_STATE_LEAVES", "STATE_LEAVES"]

Params = Dict[str, Any]
ATTN_IMPLS = ("einsum", "chunked", "pallas")
# the ``ssm`` family's cache leaves, in the order ``_rwkv_layer`` takes them
SSM_STATE_LEAVES = ("rwkv_state", "tm_prev", "cm_prev")
# the hybrid family's Mamba state and conv inputs
MAMBA_STATE_LEAVES = ("ssm_state", "conv_state")
# every cache leaf that carries state from one token to the next, which
# no mask hides, so an admission must zero it
STATE_LEAVES = SSM_STATE_LEAVES + MAMBA_STATE_LEAVES


# ======================================================================
# init
# ======================================================================
def n_dense_layers(cfg: ModelConfig) -> int:
    """How many of the layers are dense: the first ``first_k_dense`` of a
    MoE config (a cut to fewer layers keeps only dense ones), all of any
    other."""
    return min(cfg.first_k_dense, cfg.n_layers) if cfg.is_moe \
        else cfg.n_layers


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One node's parameters, drawn on ``generator.device`` one leaf at a
    time (the port's own stream; it does not reproduce JAX's numbers).
    Layer leaves are stacked ``(L, ...)`` per group, ``dense_layers``
    then ``moe_layers``, as in the reference."""
    dtype, dev = cfg.weight_dtype, generator.device
    p: Params = {
        "embed": dense_init_on_device(generator, (cfg.vocab_size, cfg.d_model),
                                      dtype, scale=0.02),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init_on_device(generator,
                                         (cfg.d_model, cfg.vocab_size), dtype)
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init_on_device(
            generator, (cfg.frontend_dim, cfg.d_model), dtype)
    n_dense = n_dense_layers(cfg)
    if n_dense:
        p["dense_layers"] = _group_init(generator, cfg, n_dense, moe=False)
    if cfg.n_layers > n_dense:
        p["moe_layers"] = _group_init(generator, cfg, cfg.n_layers - n_dense,
                                      moe=True)
    return p


def _group_init(generator, cfg: ModelConfig, L: int, moe: bool) -> Params:
    """``L`` stacked layers of one group: norms, then the time-mix and
    channel-mix (``ssm``), or attention (and the Mamba block of a hybrid
    config) and the MLP, or the MoE block."""
    dtype, dev = cfg.weight_dtype, generator.device
    stack = lambda t: t.unsqueeze(0).repeat((L,) + (1,) * t.ndim)
    layers = {
        "norm1": tree_util.tree_map(
            stack, norm_init(cfg.norm_kind, cfg.d_model, dtype, dev)),
        "norm2": tree_util.tree_map(
            stack, norm_init(cfg.norm_kind, cfg.d_model, dtype, dev)),
    }
    if cfg.family == "ssm":
        layers["time_mix"] = ssm_lib.rwkv_init(generator, cfg, dtype, L)
        layers["channel_mix"] = ssm_lib.rwkv_channel_init(generator, cfg,
                                                          dtype, L)
    else:
        layers["attn"] = (mla_init if cfg.use_mla else attention_init)(
            generator, cfg, dtype, L)
        if cfg.hybrid_ssm:
            layers["mamba"] = ssm_lib.mamba_init(generator, cfg, dtype, L)
        if moe:
            layers["moe"] = moe_init(generator, cfg, dtype, L)
        else:
            layers["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                     cfg.mlp_kind, dtype, L)
    return layers


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Sliding-window size per layer, 0 = global."""
    return [cfg.window_size if k == "local" else 0 for k in cfg.layer_kinds()]


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of node-stacked ``(N, L, ...)`` layer leaves (views)."""
    return tree_util.tree_map(lambda a: a[:, i], stacked)


def _layers(params: Params, cfg: ModelConfig):
    """``(i, layer params, is_moe)`` for every layer in order: the
    ``dense_layers`` group, then the ``moe_layers`` group."""
    n_dense = n_dense_layers(cfg)
    for i in range(cfg.n_layers):
        if i < n_dense:
            yield i, _layer(params["dense_layers"], i), False
        else:
            yield i, _layer(params["moe_layers"], i - n_dense), True


def add_node_axis(tree):
    return tree_util.tree_map(lambda a: a.unsqueeze(0), tree)


def drop_node_axis(tree):
    return tree_util.tree_map(lambda a: a[0], tree)


# ======================================================================
# forward (prefill)
# ======================================================================
class ForwardOptions:
    """attn_impl: ``"einsum"`` — full (S, T) logits;
    ``"chunked"`` — the plain online-softmax scan, O(bq·bkv) memory;
    ``"pallas"`` — the flash-attention CUDA kernel (``use_flash=True``),
    or for MLA configs the latent-attention CUDA kernel.
    use_ssm_kernel: the RWKV-6 scan through its CUDA kernel (the ``ssm``
    family's prefill; decode never runs it).

    The reference's remat/scan knobs shape a traced training program;
    the port runs eagerly and has none."""

    def __init__(self, use_flash: bool = False,
                 attn_impl: Optional[str] = None,
                 use_ssm_kernel: bool = False):
        self.use_ssm_kernel = use_ssm_kernel
        self.attn_impl = attn_impl or ("pallas" if use_flash else "einsum")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")


def _attn_block(lp, cfg, h, positions, window: int, opts: ForwardOptions):
    """Attention of the normed input ``h`` ``(N, B, S, d)``; ``window``
    is the layer's entry of :func:`_layer_windows`."""
    if cfg.use_mla:
        return mla_apply(lp["attn"], cfg, h, positions, impl=opts.attn_impl)
    return attention_apply(lp["attn"], cfg, h, positions,
                           "local" if window else "global",
                           impl=opts.attn_impl)


def _ffn_block(lp, cfg, x, moe: bool):
    """The norm and MLP, or the MoE block: (out, the aux loss ``(N,)`` of
    a MoE layer or None)."""
    h = norm_apply(cfg.norm_kind, lp["norm2"], x, cfg.norm_eps)
    if moe:
        return moe_apply(lp["moe"], cfg, h)
    return mlp_apply(lp["mlp"], h, cfg.mlp_kind), None


def _rwkv_layer(lp, cfg, x, opts: ForwardOptions, carry=None):
    """One RWKV-6 layer of every node.  ``carry`` is the decode cache's
    ``(rwkv_state, tm_prev, cm_prev)`` of this layer or None (a prefill
    from zeros); returns (x, the new carry)."""
    state, tm_prev, cm_prev = carry or (None, None, None)
    h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
    tm, state, tm_prev = ssm_lib.rwkv_time_mix(
        lp["time_mix"], cfg, h, state, tm_prev,
        use_kernel=opts.use_ssm_kernel)
    x = x + tm
    h = norm_apply(cfg.norm_kind, lp["norm2"], x, cfg.norm_eps)
    cm, cm_prev = ssm_lib.rwkv_channel_mix(lp["channel_mix"], h, cm_prev)
    return x + cm, (state, tm_prev, cm_prev)


def _node_rows(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[node, token]`` for tokens ``(N, B, S)`` → ``(N, B, S, d)``."""
    nodes = torch.arange(tokens.shape[0], device=tokens.device)
    return params["embed"][nodes[:, None, None], tokens.long()]


def _root_d(cfg: ModelConfig) -> float:
    """√d_model in f32 (correctly rounded, as XLA's), as a Python scalar:
    multiplying by a scalar launches no host-to-device copy, which would
    wait for the stream."""
    return float(np.sqrt(np.float32(cfg.d_model)))


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """The reference's ``_embed_inputs``.  Tokens ``(N, B, S)``: the rows
    times √d_model, the root taken in f32 and rounded to the embedding's
    type first (the product of two values of that type, rounded once).  A
    frontend's embeddings ``(N, B, S, F)`` (floating): cast to the
    activation type and projected by ``frontend_proj``, no scale."""
    if tokens.is_floating_point():
        x = node_matmul(tokens.to(cfg.activation_dtype),
                        params["frontend_proj"])
        return x.to(cfg.activation_dtype)
    x = _node_rows(params, tokens)
    # a CPU scalar tensor of the embedding's type: a CUDA op reads it on
    # the host (no copy, no sync)
    scale = torch.tensor(_root_d(cfg)).to(x.dtype)
    return (x * scale).to(cfg.activation_dtype)


def unembed_nodes(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """Final norm, head (the embedding's transpose when tied), f32 logits,
    then the final softcap."""
    x = norm_apply(cfg.norm_kind, params["final_norm"], x, cfg.norm_eps)
    head = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
            else params["head"])
    return softcap(node_matmul(x, head).float(), cfg.final_logit_softcap)


def _mixer(lp, cfg, h, attn_out, carry=None):
    """A hybrid layer's mix of its attention output with the Mamba block's
    on the same normed input ``h``: ``0.5·(attn + mamba)`` in the
    activation type.  ``carry`` is the decode cache's ``(ssm_state,
    conv_state)`` of this layer or None (a prefill from zeros, whose
    state is discarded); returns (out, the new carry)."""
    m_out, carry = ssm_lib.mamba_apply(lp["mamba"], cfg, h,
                                       *(carry or (None, None)))
    return 0.5 * (attn_out + m_out), carry


def forward_nodes(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  opts: Optional[ForwardOptions] = None,
                  return_hidden: bool = False):
    """Full-sequence forward of every node on its own inputs: params with
    a leading node axis N, tokens ``(N, B, S)`` or a frontend's
    embeddings ``(N, B, S, F)``.  Returns ``(logits (N, B, S, V) f32,
    aux (N,))`` — or ``(hidden, aux)`` when ``return_hidden``; ``aux`` is
    each node's auxiliary loss, the reference's sum over the MoE layers
    (zero without one)."""
    opts = opts or ForwardOptions()
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[2], device=x.device)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    windows = _layer_windows(cfg)
    for i, lp, moe in _layers(params, cfg):
        if cfg.family == "ssm":
            x, _ = _rwkv_layer(lp, cfg, x, opts)
            continue
        h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
        attn_out = _attn_block(lp, cfg, h, positions, windows[i], opts)
        if cfg.hybrid_ssm:
            attn_out, _ = _mixer(lp, cfg, h, attn_out)
        x = x + attn_out
        out, layer_aux = _ffn_block(lp, cfg, x, moe)
        x = x + out
        if layer_aux is not None:
            aux = aux + layer_aux
    if return_hidden:
        return x, aux
    return unembed_nodes(params, cfg, x), aux


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            opts: Optional[ForwardOptions] = None,
            return_hidden: bool = False):
    """The reference's single-node forward: ``batch["tokens"]`` ``(B, S)``
    or ``batch["embeddings"]`` ``(B, S, F)`` (which wins, as in the
    reference) → ``(logits (B, S, V), aux)`` (or the hidden states),
    ``aux`` a scalar."""
    inputs = batch["embeddings"] if "embeddings" in batch else batch["tokens"]
    out, aux = forward_nodes(add_node_axis(params), cfg, inputs[None],
                             opts, return_hidden)
    return out[0], aux[0]


# ======================================================================
# decode (single token, cached)
# ======================================================================
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device=None) -> Params:
    """One node's decode cache: ``position`` ``(B,)`` int32 and K/V
    ``(L, B, T, KV, hd)``.  T is uniform across layers, as in the
    reference: the longest layer's length (max_seq, or the window when
    it is longer), local layers ring-indexing inside it; only an
    all-local pattern caches just the window.  The ``ssm`` family keeps
    instead the RWKV state ``rwkv_state`` ``(L, B, H, hd, hd)`` f32 and
    the token-shift carries ``tm_prev``/``cm_prev`` ``(L, B, D)``: O(1)
    in the sequence, ``max_seq`` unused.  MLA configs keep the latent
    ``ckv`` ``(L, B, T, r)`` and the rope key ``kr`` ``(L, B, T, dr)``
    (T = max_seq) in the activation type.  A hybrid config adds to those
    the Mamba state ``ssm_state`` ``(L, B, di, n)`` f32 and the conv inputs
    ``conv_state`` ``(L, B, kdim − 1, di)`` in the activation type."""
    dev = resolve_device(device)
    position = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        hd, L, d = cfg.rwkv_head_dim, cfg.n_layers, cfg.d_model
        carry = lambda: torch.zeros((L, batch_size, d),
                                    dtype=cfg.activation_dtype, device=dev)
        return {"position": position,
                "rwkv_state": torch.zeros((L, batch_size, d // hd, hd, hd),
                                          dtype=torch.float32, device=dev),
                "tm_prev": carry(), "cm_prev": carry()}
    act = cfg.activation_dtype
    if cfg.use_mla:
        latent = lambda w: torch.zeros((cfg.n_layers, batch_size, max_seq, w),
                                       dtype=act, device=dev)
        cache = {"position": position, "ckv": latent(cfg.kv_lora_rank),
                 "kr": latent(cfg.qk_rope_head_dim)}
    else:
        kinds = cfg.layer_kinds()
        lens = [cfg.window_size if k == "local" else max_seq for k in kinds]
        t = max(lens) if lens else max_seq
        if all(k == "local" for k in kinds):
            t = min(cfg.window_size, max_seq)
        shape = (cfg.n_layers, batch_size, t, cfg.n_kv_heads, cfg.head_dim_)
        cache = {"position": position,
                 "k": torch.zeros(shape, dtype=act, device=dev),
                 "v": torch.zeros(shape, dtype=act, device=dev)}
    if cfg.hybrid_ssm:
        di = cfg.ssm_expand * cfg.d_model
        cache["ssm_state"] = torch.zeros(
            (cfg.n_layers, batch_size, di, cfg.ssm_state_dim),
            dtype=torch.float32, device=dev)
        cache["conv_state"] = torch.zeros(
            (cfg.n_layers, batch_size, cfg.ssm_conv_dim - 1, di),
            dtype=act, device=dev)
    return cache


def decode_step_nodes(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Params, opts: Optional[ForwardOptions] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """One decode step of every node: tokens ``(N, B, 1)``, the cache with
    a leading node axis (``position`` ``(N, B)``, K/V ``(N, L, B, T, KV,
    hd)``, MLA's ``ckv``/``kr`` ``(N, L, B, T, ·)``, the ``ssm``
    family's state leaves, and a hybrid config's ``ssm_state``/
    ``conv_state`` ``(N, L, B, ·)`` beside K/V) → (logits
    ``(N, B, 1, V)``, new cache).  ``opts`` is accepted for the
    reference's signature; decode attention is always einsum and the
    RWKV scan always the one-step body."""
    x = _node_rows(params, tokens)
    # the reference multiplies the embedding by the f32 root here (an f32
    # product), where _embed_inputs rounds the root to the embedding's type
    x = (x.float() * _root_d(cfg)).to(cfg.activation_dtype)
    position = cache["position"]
    if cfg.family == "ssm":
        carries = []
        for i in range(cfg.n_layers):
            x, carry = _rwkv_layer(
                _layer(params["dense_layers"], i), cfg, x, ForwardOptions(),
                tuple(cache[k][:, i] for k in SSM_STATE_LEAVES))
            carries.append(carry)
        new_cache = {"position": position + 1}
        for j, k in enumerate(SSM_STATE_LEAVES):
            new_cache[k] = torch.stack([c[j] for c in carries], 1)
        return unembed_nodes(params, cfg, x), new_cache
    keys = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    news = {k: [] for k in keys + (MAMBA_STATE_LEAVES if cfg.hybrid_ssm
                                   else ())}
    windows = _layer_windows(cfg)
    for i, lp, moe in _layers(params, cfg):
        window = windows[i]
        h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
        layer_cache = [cache[k][:, i] for k in keys]
        if cfg.use_mla:
            a_out, *new = mla_decode(lp["attn"], cfg, h, *layer_cache,
                                     position)
        else:
            a_out, *new = attention_decode(
                lp["attn"], cfg, h, *layer_cache, position,
                "local" if window else "global", window)
        for k, t in zip(keys, new):
            news[k].append(t)
        if cfg.hybrid_ssm:
            a_out, carry = _mixer(lp, cfg, h, a_out, tuple(
                cache[k][:, i] for k in MAMBA_STATE_LEAVES))
            for k, t in zip(MAMBA_STATE_LEAVES, carry):
                news[k].append(t)
        x = x + a_out
        x = x + _ffn_block(lp, cfg, x, moe)[0]
    new_cache = {"position": position + 1,
                 **{k: torch.stack(v, 1) for k, v in news.items()}}
    return unembed_nodes(params, cfg, x), new_cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, opts: Optional[ForwardOptions] = None
                ) -> Tuple[torch.Tensor, Params]:
    """The reference's single-node decode step: tokens ``(B, 1)`` →
    (logits ``(B, 1, V)``, new cache)."""
    logits, new_cache = decode_step_nodes(
        add_node_axis(params), cfg, tokens[None], add_node_axis(cache), opts)
    return logits[0], drop_node_axis(new_cache)
