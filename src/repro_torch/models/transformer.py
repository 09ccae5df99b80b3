"""Model assembly for the dense and SSM families and MLA (port of
``repro/models/transformer.py``).

  dense — [norm → GQA or MLA attention → +res] [norm → MLP → +res]  (× L)
  ssm   — [norm → RWKV-6 time-mix → +res] [norm → channel-mix → +res]

The parameter tree is the reference's: ``embed``, ``final_norm``,
``head`` (unless tied) and ``dense_layers``, whose leaves are stacked
along a leading L axis.  The reference scans the layers and ``vmap``s
the fleet's node axis; the port loops over the layers in Python and
writes the node axis out: :func:`forward_nodes` and
:func:`decode_step_nodes` take every parameter leaf with a leading node
axis N (``dense_layers`` leaves are ``(N, L, ...)``) and tokens
``(N, B, S)``, so a fleet's prefill makes one attention call per layer
for all its nodes.  :func:`forward` and :func:`decode_step` are the
reference's single-node signatures, ``N = 1``.

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
(``models/ssm.py``).

A ``moe`` config runs when it has no MoE layer: deepseek-v2 cut to its
dense first layer (``n_layers <= first_k_dense``), or one with
``n_experts = 0``.  The MoE block, the hybrid family and the modality
frontends raise ``NotImplementedError`` (ROADMAP Queue 1 [moe], [mamba]
and [frontends]).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    _causal_mask,
    _qk_norm,
    _qkv,
    _sdpa,
    _sdpa_chunked,
    _fold,
    additive_mask,
    apply_rope,
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
    rope,
    softcap,
)

__all__ = ["init_params", "forward", "forward_nodes", "init_cache",
           "decode_step", "decode_step_nodes", "unembed_nodes",
           "ForwardOptions", "ATTN_IMPLS", "SSM_STATE_LEAVES"]

Params = Dict[str, Any]
ATTN_IMPLS = ("einsum", "chunked", "pallas")
# the cache leaves that carry state from one token to the next (the
# ``ssm`` family's), in the order ``_rwkv_layer`` takes them
SSM_STATE_LEAVES = ("rwkv_state", "tm_prev", "cm_prev")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's transformer stack does not run yet."""
    if cfg.family == "hybrid" or cfg.hybrid_ssm:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid block (Mamba beside attention) is not "
            f"ported yet (ROADMAP Queue 1 [mamba])")
    if cfg.is_moe and cfg.n_layers > cfg.first_k_dense:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_layers - cfg.first_k_dense} of its "
            f"{cfg.n_layers} layers are MoE layers, and the MoE block "
            f"(models/moe.py) is not ported yet (ROADMAP Queue 1 [moe]); "
            f"a cut to its first {cfg.first_k_dense} dense layer(s) runs")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            f"(ROADMAP Queue 1 [frontends])")


# ======================================================================
# init
# ======================================================================
def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One node's parameters, drawn on ``generator.device`` one leaf at a
    time (the port's own stream; it does not reproduce JAX's numbers).
    Layer leaves are stacked ``(L, ...)`` as in the reference."""
    check_supported(cfg)
    dtype, dev, L = cfg.weight_dtype, generator.device, cfg.n_layers
    p: Params = {
        "embed": dense_init_on_device(generator, (cfg.vocab_size, cfg.d_model),
                                      dtype, scale=0.02),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init_on_device(generator,
                                         (cfg.d_model, cfg.vocab_size), dtype)
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
        layers["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                 cfg.mlp_kind, dtype, L)
    p["dense_layers"] = layers
    return p


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Sliding-window size per layer, 0 = global."""
    return [cfg.window_size if k == "local" else 0 for k in cfg.layer_kinds()]


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of node-stacked ``(N, L, ...)`` layer leaves (views)."""
    return tree_util.tree_map(lambda a: a[:, i], stacked)


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


def _attn_block(lp, cfg, x, positions, window: int, opts: ForwardOptions):
    h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
    if cfg.use_mla:
        return mla_apply(lp["attn"], cfg, h, positions, impl=opts.attn_impl)
    q, k, v = _qkv(lp["attn"], cfg, h, positions)
    n, b, s = q.shape[:3]
    q, k, v = _fold(q), _fold(k), _fold(v)
    if opts.attn_impl == "pallas":
        out = flash_attention(q, k, v, causal=True, window=window,
                              logit_softcap=cfg.attn_logit_softcap)
    elif opts.attn_impl == "chunked":
        out = _sdpa_chunked(cfg, q, k, v, window=window)
    else:
        out = _sdpa(cfg, q, k, v, _causal_mask(s, s, 0, window, x.device))
    out = out.reshape(n, b, s, -1)
    return node_matmul(out, lp["attn"]["wo"].flatten(1, 2))


def _ffn_block(lp, cfg, x):
    h = norm_apply(cfg.norm_kind, lp["norm2"], x, cfg.norm_eps)
    return mlp_apply(lp["mlp"], h, cfg.mlp_kind)


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
    """The reference's ``_embed_inputs``: the rows times √d_model, the
    root taken in f32 and rounded to the embedding's type first (the
    product of two values of that type, rounded once)."""
    x = _node_rows(params, tokens)
    scale = torch.tensor(_root_d(cfg)).to(x.dtype).item()
    return (x * scale).to(cfg.activation_dtype)


def unembed_nodes(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """Final norm, head (the embedding's transpose when tied), f32 logits,
    then the final softcap."""
    x = norm_apply(cfg.norm_kind, params["final_norm"], x, cfg.norm_eps)
    head = (params["embed"].transpose(1, 2) if cfg.tie_embeddings
            else params["head"])
    return softcap(node_matmul(x, head).float(), cfg.final_logit_softcap)


def forward_nodes(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  opts: Optional[ForwardOptions] = None,
                  return_hidden: bool = False):
    """Full-sequence forward of every node on its own tokens: params with
    a leading node axis N, tokens ``(N, B, S)``.  Returns
    ``(logits (N, B, S, V) f32, aux)`` — or ``(hidden, aux)`` when
    ``return_hidden``; ``aux`` is the reference's (zero for dense)
    auxiliary loss."""
    check_supported(cfg)
    opts = opts or ForwardOptions()
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params["dense_layers"], i)
        if cfg.family == "ssm":
            x, _ = _rwkv_layer(lp, cfg, x, opts)
            continue
        x = x + _attn_block(lp, cfg, x, positions, window, opts)
        x = x + _ffn_block(lp, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed_nodes(params, cfg, x), aux


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            opts: Optional[ForwardOptions] = None,
            return_hidden: bool = False):
    """The reference's single-node forward: ``batch["tokens"]`` ``(B, S)``
    → ``(logits (B, S, V), aux)`` (or the hidden states)."""
    if "tokens" not in batch:
        raise NotImplementedError(
            "forward: only token inputs; the frontend stubs' embeddings are "
            "not ported yet (ROADMAP Queue 1 [frontends])")
    out, aux = forward_nodes(add_node_axis(params), cfg, batch["tokens"][None],
                             opts, return_hidden)
    return out[0], aux


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
    (T = max_seq) in the activation type."""
    check_supported(cfg)
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
    if cfg.use_mla:
        latent = lambda w: torch.zeros((cfg.n_layers, batch_size, max_seq, w),
                                       dtype=cfg.activation_dtype, device=dev)
        return {"position": position, "ckv": latent(cfg.kv_lora_rank),
                "kr": latent(cfg.qk_rope_head_dim)}
    kinds = cfg.layer_kinds()
    lens = [cfg.window_size if k == "local" else max_seq for k in kinds]
    t = max(lens) if lens else max_seq
    if all(k == "local" for k in kinds):
        t = min(cfg.window_size, max_seq)
    shape = (cfg.n_layers, batch_size, t, cfg.n_kv_heads, cfg.head_dim_)
    return {"position": position,
            "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev)}


def _attn_decode(p, cfg, x, cache_k, cache_v, position, window: int):
    """One token against one layer's cache, every node at once: x
    ``(N, B, 1, d)``, cache ``(N, B, T, KV, hd)``, position ``(N, B)``.
    Local layers (``window > 0``) ring-index the cache and see the last
    ``window`` positions; global layers write at ``min(position, T − 1)``.
    Returns (out, new_k, new_v)."""
    q = node_matmul(x, p["wq"])
    k = node_matmul(x, p["wk"])
    v = node_matmul(x, p["wv"])
    q, k = _qk_norm(p, cfg, q, k)
    cos, sin = rope(position[..., None], cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    t = cache_k.shape[2]
    slot = position % t if window > 0 else torch.clamp_max(position, t - 1)
    kpos = torch.arange(t, device=x.device)
    write = (kpos == slot[..., None])[..., None, None]        # (N, B, T, 1, 1)
    new_k = torch.where(write, k, cache_k)
    new_v = torch.where(write, v, cache_v)
    if window > 0:
        age = (slot[..., None] - kpos) % t
        ok = ((age <= torch.clamp_max(position, t - 1)[..., None])
              & (age < window))
    else:
        ok = kpos <= position[..., None]
    mask = additive_mask(ok)                                     # (N, B, T)
    n, b = position.shape
    out = _sdpa(cfg, _fold(q), _fold(new_k), _fold(new_v),
                mask.reshape(n * b, 1, 1, 1, t))
    out = out.reshape(n, b, 1, -1)
    return node_matmul(out, p["wo"].flatten(1, 2)), new_k, new_v


def decode_step_nodes(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Params, opts: Optional[ForwardOptions] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """One decode step of every node: tokens ``(N, B, 1)``, the cache with
    a leading node axis (``position`` ``(N, B)``, K/V ``(N, L, B, T, KV,
    hd)``, MLA's ``ckv``/``kr`` ``(N, L, B, T, ·)``, or the ``ssm``
    family's state leaves) → (logits
    ``(N, B, 1, V)``, new cache).  ``opts`` is accepted for the
    reference's signature; decode attention is always einsum and the
    RWKV scan always the one-step body."""
    check_supported(cfg)
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
    news = {k: [] for k in keys}
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params["dense_layers"], i)
        h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
        layer_cache = [cache[k][:, i] for k in keys]
        if cfg.use_mla:
            a_out, *new = mla_decode(lp["attn"], cfg, h, *layer_cache,
                                     position)
        else:
            a_out, *new = _attn_decode(lp["attn"], cfg, h, *layer_cache,
                                       position, window)
        for k, t in zip(keys, new):
            news[k].append(t)
        x = x + a_out
        x = x + _ffn_block(lp, cfg, x)
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
