"""Shared neural building blocks (port of ``repro/models/layers.py``).

Params are nested dicts of tensors, as in the reference.  The reference
``vmap``s its model over the node axis; the port writes that axis out:
every function below that touches a weight takes the weight with a
leading node axis ``N`` and the activations as ``(N, B, S, ...)``, so one
call serves the whole fleet (a single node is ``N = 1``).  Attention
itself holds no weight and runs on the node axis folded into the batch,
``(N·B, S, H, hd)``.

Weight layouts are the reference's, behind the node axis:
  * attention q: ``(N, d_model, n_heads, hd)``; k, v: ``(N, d_model, KV, hd)``;
    o: ``(N, n_heads, hd, d_model)``;
  * MLA (deepseek-v2): w_dkv ``(N, d, r)``, w_kr ``(N, d, dr)``, w_uk
    ``(N, r, H, dn)``, w_uv ``(N, r, H, dv)``, w_o ``(N, H, dv, d)``, and
    w_dq ``(N, d, q_lora)`` + w_uq ``(N, q_lora, H, dn + dr)`` or wq
    ``(N, d, H, dn + dr)``;
  * MLP: wi/wg ``(N, d_model, d_ff)``, wo ``(N, d_ff, d_model)``;
  * norms: ``(N, d)`` vectors.

The RWKV-6 and Mamba blocks live in ``models/ssm.py``, the MoE block in
``models/moe.py``.  The reference's ``attention_apply`` and
``attention_decode`` are on no path of the port: its forward and decode
call ``_qkv``, ``_sdpa`` and ``_attn_decode`` directly.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "dense_init_on_device",
    "rmsnorm_init", "rmsnorm",
    "layernorm_init", "layernorm",
    "norm_init", "norm_apply",
    "softcap",
    "rope", "apply_rope",
    "attention_init",
    "mla_init", "mla_apply", "mla_decode", "mla_chunked",
    "mlp_init", "mlp_apply",
    "node_matmul",
]

NEG_INF = -1e30   # the reference's mask value


def additive_mask(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, −1e30 elsewhere, f32.  ``masked_fill`` takes the
    value as a kernel argument; ``torch.where`` with a Python scalar
    would first copy it to the device, which waits for the stream."""
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill_(~ok, NEG_INF)


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               device=None, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, layout ``(in, out)``.  Drawn on
    the CPU from ``generator`` (the port's own stream — it does not
    reproduce JAX's numbers), then moved to ``device``.  The FFN and
    VGG-16 inits use it."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return (t * std).to(dtype=dtype, device=device)


def dense_init_on_device(generator: torch.Generator, shape: Sequence[int],
                         dtype, scale: Optional[float] = None,
                         stacked: int = 0) -> torch.Tensor:
    """:func:`dense_init` drawn on ``generator.device`` (the card for the
    transformer zoo, whose billions of draws would take minutes on the
    host).  ``stacked`` leading axes are stacking axes (layers), not part
    of the fan-in."""
    per = tuple(shape[stacked:])
    fan_in = per[0] if len(per) >= 2 else per[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return t.mul_(std).to(dtype)


def _tail(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Align a ``(d,)`` or node-stacked ``(N, d)`` vector with the last
    axis of an ``ndim``-rank ``(N, ..., d)`` activation."""
    return v.reshape(v.shape[:-1] + (1,) * (ndim - v.ndim) + v.shape[-1:])


def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps):
    """Gemma-style ``(1 + scale)`` RMSNorm, computed in f32."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = 1.0 + p["scale"].float()
    return (y * _tail(scale, y.ndim)).to(x.dtype)


def layernorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps):
    """LayerNorm with the config's ``eps`` (not torch's 1e-5), in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * _tail(p["scale"].float(), y.ndim)
            + _tail(p["bias"].float(), y.ndim)).to(x.dtype)


def norm_init(kind, d, dtype, device=None):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def norm_apply(kind, p, x, eps):
    return rmsnorm(p, x, eps) if kind == "rmsnorm" else layernorm(p, x, eps)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., S)`` positions → cos/sin ``(..., S, head_dim // 2)``, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    # a Python scalar base: a device tensor built from it would be a host
    # to device copy, which waits for the stream
    freqs = 1.0 / torch.pow(float(np.float32(theta)), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE (not interleaved) in f32, cast back.  x:
    ``(..., S, H, hd)``; cos/sin: ``(S, hd/2)`` or ``(..., S, hd/2)``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos_, sin_ = cos.unsqueeze(-2), sin.unsqueeze(-2)
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# masks
# ----------------------------------------------------------------------
def _causal_mask(s_q: int, s_kv: int, q_offset: int = 0, window: int = 0,
                 device=None) -> torch.Tensor:
    """``(s_q, s_kv)`` additive mask; ``window > 0`` adds the sliding
    window bound.  ``q_offset`` is the absolute position of query 0."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return additive_mask(ok)


# ----------------------------------------------------------------------
# GQA attention
# ----------------------------------------------------------------------
def node_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (N, ..., a) @ w (N, a, *out)`` → ``(N, ..., *out)``: one batched
    product over the node axis (the reference's vmapped ``x @ w`` /
    ``einsum("bsd,dhk->bshk")``)."""
    n, a = x.shape[0], x.shape[-1]
    out_shape = w.shape[2:]
    y = torch.bmm(x.reshape(n, -1, a), w.reshape(n, a, -1))
    return y.reshape(x.shape[:-1] + out_shape)


def attention_init(generator, cfg, dtype, layers: int):
    """Stacked ``(layers, ...)`` GQA weights drawn on the generator's
    device, one leaf at a time."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    init = lambda shape: dense_init_on_device(generator, (layers,) + shape,
                                              dtype, stacked=1)
    p = {"wq": init((d, h, hd)), "wk": init((d, kv, hd)),
         "wv": init((d, kv, hd)), "wo": init((h, hd, d))}
    if cfg.qk_norm:
        dev = generator.device
        p["q_norm"] = {"scale": torch.zeros((layers, hd), dtype=dtype,
                                            device=dev)}
        p["k_norm"] = {"scale": torch.zeros((layers, hd), dtype=dtype,
                                            device=dev)}
    return p


def _qk_norm(p, cfg, q, k):
    """Per-head RMSNorm of q and k (``qk_norm`` configs); the node-stacked
    ``(N, hd)`` scale broadcasts over ``(N, B, S, H, hd)``."""
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k


def _qkv(p, cfg, x, positions):
    """x ``(N, B, S, d)`` → roped q ``(N, B, S, H, hd)``, k and v
    ``(N, B, S, KV, hd)``."""
    q = node_matmul(x, p["wq"])
    k = node_matmul(x, p["wk"])
    v = node_matmul(x, p["wv"])
    q, k = _qk_norm(p, cfg, q, k)
    cos, sin = rope(positions, cfg.head_dim_, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(cfg, q, k, v, mask):
    """Grouped-query core attention.  q ``(B, S, H, hd)``, k/v
    ``(B, T, KV, hd)``; ``mask`` is ``(S, T)`` (the causal path) or
    ``(B, 1, 1, 1, T)`` (decode), added to the logits."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _sdpa_chunked(cfg, q, k, v, q_offset: int = 0, window: int = 0,
                  bq: int = 512, bkv: int = 512):
    """Online-softmax attention in plain PyTorch (``attn_impl="chunked"``):
    q blocks × kv blocks with the reference's (m, l, acc) carry, memory
    O(bq·bkv) per (batch, head).  q ``(B, S, H, hd)``; k/v
    ``(B, T, KV, hd)``; causal, optional sliding window.

    Blocks wholly above the diagonal or wholly at or before ``s − window``
    for every row of the q block are skipped.  That is exact: the
    reference computes them, but a block above the diagonal adds p = 0
    with alpha = 1, and the p = 1 a wholly masked leading block
    accumulates is wiped by alpha = exp(−1e30 − m) = 0 at the row's first
    real logit."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq, bkv = min(bq, s), min(bkv, t)
    if s % bq or t % bkv:
        raise ValueError(f"_sdpa_chunked: S={s}, T={t} must be multiples of "
                         f"the blocks ({bq}, {bkv})")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float().reshape(b, s, kvh, g, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, kvh, g, hd), dtype=torch.float32, device=dev)
    for qi in range(s // bq):
        q_lo = q_offset + qi * bq
        qblk = qf[:, qi * bq:(qi + 1) * bq]
        qpos = q_lo + torch.arange(bq, device=dev)[:, None]
        acc = torch.zeros((b, kvh, g, bq, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32, device=dev)
        for ki in range(t // bkv):
            k_lo = ki * bkv
            if k_lo > q_lo + bq - 1:
                break
            if window > 0 and k_lo + bkv - 1 <= q_lo - window:
                continue
            kblk = kf[:, k_lo:k_lo + bkv]
            logits = torch.einsum("bskgh,btkh->bkgst", qblk, kblk) * scale
            logits = softcap(logits, cfg.attn_logit_softcap)
            kpos = k_lo + torch.arange(bkv, device=dev)[None, :]
            ok = kpos <= qpos
            if window > 0:
                ok &= kpos > qpos - window
            logits = logits.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkh->bkgsh", p, vf[:, k_lo:k_lo + bkv])
            m = m_new
        blk = acc / torch.clamp_min(l[..., None], 1e-30)
        out[:, qi * bq:(qi + 1) * bq] = blk.permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).to(q.dtype)


# ----------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ----------------------------------------------------------------------
def mla_init(generator, cfg, dtype, layers: int):
    """Stacked ``(layers, ...)`` MLA weights drawn on the generator's
    device, one leaf at a time: the latent compressor ``w_dkv``, the shared
    rope key ``w_kr``, the latent up-projections ``w_uk``/``w_uv``, the
    output ``w_o``, ``kv_norm``, and the query path (``w_dq``, ``w_uq``,
    ``q_norm`` when ``q_lora_rank > 0``, else ``wq``)."""
    d, h = cfg.d_model, cfg.n_heads
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = generator.device
    init = lambda shape: dense_init_on_device(generator, (layers,) + shape,
                                              dtype, stacked=1)
    norm = lambda n: {"scale": torch.zeros((layers, n), dtype=dtype,
                                           device=dev)}
    p = {"w_dkv": init((d, r)), "w_kr": init((d, dr)),
         "w_uk": init((r, h, dn)), "w_uv": init((r, h, dv)),
         "w_o": init((h, dv, d)), "kv_norm": norm(r)}
    if cfg.q_lora_rank:
        p["w_dq"] = init((d, cfg.q_lora_rank))
        p["w_uq"] = init((cfg.q_lora_rank, h, dn + dr))
        p["q_norm"] = norm(cfg.q_lora_rank)
    else:
        p["wq"] = init((d, h, dn + dr))
    return p


def _mla_q(p, cfg, x):
    """x ``(N, B, S, d)`` → q_nope ``(N, B, S, H, dn)``, q_rope
    ``(N, B, S, H, dr)`` (not yet roped), through the low-rank query path
    when ``q_lora_rank > 0``."""
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], node_matmul(x, p["w_dq"]), cfg.norm_eps)
        q = node_matmul(cq, p["w_uq"])
    else:
        q = node_matmul(x, p["wq"])
    dn = cfg.qk_nope_head_dim
    return q[..., :dn], q[..., dn:]


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_latents(p, cfg, x, cos, sin):
    """The latent ``c_kv`` ``(N, B, S, r)`` (RMS-normed) and the roped
    shared key ``k_rope`` ``(N, B, S, dr)``, in x's type."""
    c_kv = rmsnorm(p["kv_norm"], node_matmul(x, p["w_dkv"]), cfg.norm_eps)
    k_rope = apply_rope(node_matmul(x, p["w_kr"])[..., None, :], cos, sin)
    return c_kv, k_rope[..., 0, :]


def _mla_absorb(p, q_nope):
    """``w_uk`` absorbed into the query, in f32: q_lat ``(N, B, S, H, r)``
    with ``logits = q_lat · c_kv + q_rope · k_rope``."""
    return torch.einsum("nbshk,nrhk->nbshr", q_nope.float(),
                        p["w_uk"].float())


def _mla_out(p, ctx, dtype):
    """The latent context ``(N, B, S, H, r)`` f32 → up-projected by
    ``w_uv`` in f32, cast to the activation type, through ``w_o``."""
    out = torch.einsum("nbshr,nrhv->nbshv", ctx, p["w_uv"].float())
    return node_matmul(out.to(dtype).flatten(-2), p["w_o"].flatten(1, 2))


def mla_chunked(cfg, q_lat, q_rope, c_kv, k_rope, q_offset: int = 0,
                bq: int = 512, bkv: int = 512):
    """Online-softmax MLA attention in latent space, in plain PyTorch
    (``attn_impl="chunked"``).  q_lat ``(B, S, H, r)``, q_rope
    ``(B, S, H, dr)``, c_kv ``(B, T, r)``, k_rope ``(B, T, dr)`` → latent
    context ``(B, S, H, r)`` f32; memory O(bq·bkv) per head.  As the
    reference, S and T must be multiples of the blocks.  Blocks wholly
    above the diagonal are skipped, which is exact (they add p = 0 with
    alpha = 1)."""
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    bq, bkv = min(bq, s), min(bkv, t)
    assert s % bq == 0 and t % bkv == 0, (s, bq, t, bkv)
    scale = _mla_scale(cfg)
    dev = q_lat.device
    qlf, qrf = q_lat.float(), q_rope.float()
    ckf, krf = c_kv.float(), k_rope.float()
    out = torch.empty((b, s, h, r), dtype=torch.float32, device=dev)
    for qi in range(s // bq):
        q_lo = q_offset + qi * bq
        ql, qr = qlf[:, qi * bq:(qi + 1) * bq], qrf[:, qi * bq:(qi + 1) * bq]
        qpos = q_lo + torch.arange(bq, device=dev)[:, None]
        acc = torch.zeros((b, h, bq, r), dtype=torch.float32, device=dev)
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        for ki in range(t // bkv):
            k_lo = ki * bkv
            if k_lo > q_lo + bq - 1:
                break
            ck, kr = ckf[:, k_lo:k_lo + bkv], krf[:, k_lo:k_lo + bkv]
            logits = torch.einsum("bshr,btr->bhst", ql, ck)
            logits += torch.einsum("bshk,btk->bhst", qr, kr)
            logits *= scale
            kpos = k_lo + torch.arange(bkv, device=dev)[None, :]
            logits = logits.masked_fill(~(kpos <= qpos), NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhst,btr->bhsr", p,
                                                        ck)
            m = m_new
        blk = acc / torch.clamp_min(l[..., None], 1e-30)
        out[:, qi * bq:(qi + 1) * bq] = blk.permute(0, 2, 1, 3)
    return out


def _fold(t: torch.Tensor) -> torch.Tensor:
    """``(N, B, ...)`` → ``(N·B, ...)``."""
    return t.reshape((t.shape[0] * t.shape[1],) + t.shape[2:])


def mla_apply(p, cfg, x, positions, impl: str = "einsum"):
    """Full-sequence MLA of every node: x ``(N, B, S, d)``, positions
    ``(S,)``.  ``impl``: ``"einsum"`` (full ``(S, S)`` logits),
    ``"chunked"`` (:func:`mla_chunked`) or ``"pallas"`` (the latent
    attention CUDA kernel, ``kernels.mla_attention``, one launch for the
    fleet: the node axis folded into the batch).  The kernel branch keeps
    the reference's pre-scaling and types: q_lat f32 times 1/√(dn + dr),
    q_rope times the scale rounded to the activation type, then cast to
    f32; c_kv and k_rope in the activation type; the context f32."""
    from repro_torch.kernels.mla_attention import mla_attention

    n, b, s = x.shape[:3]
    q_nope, q_rope = _mla_q(p, cfg, x)
    cos, sin = rope(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv, k_rope = _mla_latents(p, cfg, x, cos, sin)
    q_lat = _mla_absorb(p, q_nope)
    scale = _mla_scale(cfg)
    if impl == "pallas":
        # the reference multiplies q_rope by a weakly typed scalar, which
        # takes q_rope's type first
        typed = torch.tensor(scale).to(q_rope.dtype).item()
        ctx = mla_attention(_fold(q_lat * scale),
                            _fold((q_rope * typed).to(q_lat.dtype)),
                            _fold(c_kv), _fold(k_rope)).float()
    elif impl == "chunked":
        ctx = mla_chunked(cfg, _fold(q_lat), _fold(q_rope), _fold(c_kv),
                          _fold(k_rope))
    else:
        ckf = _fold(c_kv).float()
        logits = torch.einsum("bshr,btr->bhst", _fold(q_lat), ckf)
        logits += torch.einsum("bshk,btk->bhst", _fold(q_rope).float(),
                               _fold(k_rope).float())
        logits = logits * scale + _causal_mask(s, s, 0, 0, x.device)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs, ckf)
    return _mla_out(p, ctx.reshape(q_lat.shape), x.dtype)


def mla_decode(p, cfg, x, cache_ckv, cache_kr, position):
    """One token of every node against one layer's latent cache: x
    ``(N, B, 1, d)``, cache_ckv ``(N, B, T, r)``, cache_kr
    ``(N, B, T, dr)``, position ``(N, B)``.  The new latent and rope key
    are written at ``position`` (nowhere when it is past T, as the
    reference's one-hot blend); returns (out, new_ckv, new_kr)."""
    q_nope, q_rope = _mla_q(p, cfg, x)
    cos, sin = rope(position[..., None], cfg.qk_rope_head_dim,
                    cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_new, kr_new = _mla_latents(p, cfg, x, cos, sin)

    t = cache_ckv.shape[2]
    kpos = torch.arange(t, device=x.device)
    write = (kpos == position[..., None])[..., None]         # (N, B, T, 1)
    new_ckv = torch.where(write, c_new, cache_ckv)
    new_kr = torch.where(write, kr_new, cache_kr)

    q_lat = _mla_absorb(p, q_nope)
    ckf = new_ckv.float()
    logits = torch.einsum("nbshr,nbtr->nbhst", q_lat, ckf)
    logits += torch.einsum("nbshk,nbtk->nbhst", q_rope.float(),
                           new_kr.float())
    logits = logits * _mla_scale(cfg)
    mask = additive_mask(kpos <= position[..., None])          # (N, B, T)
    probs = torch.softmax(logits + mask[:, :, None, None, :], dim=-1)
    ctx = torch.einsum("nbhst,nbtr->nbshr", probs, ckf)
    return _mla_out(p, ctx, x.dtype), new_ckv, new_kr


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
def mlp_init(generator, d_model, d_ff, kind, dtype, layers: int):
    """Stacked ``(layers, ...)`` MLP weights on the generator's device."""
    init = lambda shape: dense_init_on_device(generator, (layers,) + shape,
                                              dtype, stacked=1)
    if kind in ("swiglu", "geglu"):
        return {"wg": init((d_model, d_ff)), "wi": init((d_model, d_ff)),
                "wo": init((d_ff, d_model))}
    return {"wi": init((d_model, d_ff)), "wo": init((d_ff, d_model))}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, kind):
    """x ``(N, B, S, d)`` with node-stacked weights."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        return node_matmul(act(node_matmul(x, p["wg"]))
                           * node_matmul(x, p["wi"]), p["wo"])
    return node_matmul(_gelu(node_matmul(x, p["wi"])), p["wo"])
