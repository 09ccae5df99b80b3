"""RWKV-6 ("Finch") time-mix and channel-mix, and the Mamba-style
selective SSM (port of ``repro/models/ssm.py``).

RWKV-6 time-mix (per head, head_dim N):
    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ            (state: N×N)
    y_t = r_tᵀ · (S_{t-1} + diag(u) k_t v_tᵀ)
with data-dependent per-channel decay  w_t = exp(-exp(ddlerp(x_t, x_{t-1})))
(low-rank token-shift mixers, per the Finch paper arXiv:2404.05892).

The node axis is written out as in ``models/transformer.py``: every weight
carries a leading node axis N (stacked layers ``(N, L, ...)``, one layer
``(N, ...)``) and activations are ``(N, B, S, D)``.  The scan runs by
``use_kernel``: the RWKV-6 CUDA kernel (``kernels.ssm_scan.rwkv_scan``)
with the node axis folded into the batch, one launch for the fleet; or
the reference's own one-step scan body in a Python loop over time, which
is what decode runs.

The Mamba block (the hybrid family's SSM heads, hymba-1.5b) is a diagonal
selective scan per channel:
    h_t = exp(Δ_t·A) ⊙ h_{t-1} + (Δ_t·B_t)·u_t      (state: di × n, f32)
    y_t = h_t · C_t
after a depthwise causal conv over time.  The reference runs the
recurrence as a ``jax.lax.scan`` (no Pallas kernel); the port runs it as
a plain loop over time on the node axis folded into the batch, with the
elementwise ``exp(Δ·A)`` and ``(Δ·B)·u`` of every step computed before the
loop, so each step is one fused multiply-add (:func:`_mamba_scan`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import rwkv_scan
from repro_torch.models.layers import (
    _tail,
    dense_init_on_device,
    node_matmul,
    rmsnorm,
)

__all__ = [
    "rwkv_init", "rwkv_time_mix", "rwkv_time_mix_decode",
    "rwkv_channel_mix", "rwkv_channel_init",
    "mamba_init", "mamba_apply", "mamba_decode",
]

_LORA = 32  # low-rank dim of the RWKV-6 token-shift mixers


def rwkv_init(generator: torch.Generator, cfg, dtype, layers: int):
    """Stacked ``(layers, ...)`` time-mix weights drawn on the generator's
    device, one leaf at a time.  ``decay_base`` and ``bonus_u`` stay f32
    in a bf16 model, as in the reference."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dev = generator.device
    init = lambda shape, dt=dtype, scale=None: dense_init_on_device(
        generator, (layers,) + shape, dt, scale=scale, stacked=1)
    return {
        # token-shift lerp weights (mu) for the r, k, v, g, w paths
        "mu_x": torch.zeros((layers, 5, d), dtype=dtype, device=dev),
        "lora_a": init((5, d, _LORA)),
        "lora_b": init((5, _LORA, d)),
        "wr": init((d, h, hd)),
        "wk": init((d, h, hd)),
        "wv": init((d, h, hd)),
        "wg": init((d, h, hd)),
        "wo": init((h, hd, d)),
        # data-dependent decay: w_t = exp(-exp(base + lora(x̄_t)))
        "decay_base": torch.full((layers, h, hd), -4.0, dtype=torch.float32,
                                 device=dev),
        "decay_a": init((d, 64)),
        "decay_b": init((64, d)),
        "bonus_u": init((h, hd), torch.float32, 0.5),
        "ln_out": {"scale": torch.zeros((layers, d), dtype=dtype,
                                        device=dev)},
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along the sequence of ``(N, B, S, D)``; ``x_prev``
    ``(N, B, D)`` seeds position -1 (the decode carry)."""
    return torch.cat([x_prev[:, :, None], x[:, :, :-1]], dim=2)


def _ddlerp(p, idx: int, x, xs):
    """Finch's data-dependent lerp between x_t and x_{t-1} (low-rank)."""
    dx = xs - x
    mix = _tail(p["mu_x"][:, idx], x.ndim) + node_matmul(
        torch.tanh(node_matmul(dx, p["lora_a"][:, idx])), p["lora_b"][:, idx])
    return x + dx * mix


def _rwkv_rkvgw(p, cfg, x, xs):
    hd = cfg.rwkv_head_dim
    h = cfg.d_model // hd
    n, b, s, _ = x.shape
    r = node_matmul(_ddlerp(p, 0, x, xs), p["wr"])
    k = node_matmul(_ddlerp(p, 1, x, xs), p["wk"])
    v = node_matmul(_ddlerp(p, 2, x, xs), p["wv"])
    g = node_matmul(_ddlerp(p, 3, x, xs), p["wg"])
    dec_in = _ddlerp(p, 4, x, xs)
    dec = node_matmul(torch.tanh(node_matmul(dec_in, p["decay_a"])),
                      p["decay_b"]).reshape(n, b, s, h, hd)
    base = p["decay_base"].reshape(n, 1, 1, h, hd)
    w = torch.exp(-torch.exp(base + dec.float()))  # (N,B,S,H,hd) in (0, 1)
    return r, k, v, g, w


def rwkv_time_mix(p, cfg, x, state=None, x_prev=None,
                  use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence RWKV-6 time-mix of every node.

    Args:
      x: ``(N, B, S, D)``;  state: ``(N, B, H, hd, hd)`` f32 carry or None;
      x_prev: ``(N, B, D)`` or None.
    Returns (out ``(N, B, S, D)``, final state, last x ``(N, B, D)``)."""
    n, b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    if state is None:
        state = torch.zeros((n, b, h, hd, hd), dtype=torch.float32,
                            device=x.device)
    if x_prev is None:
        x_prev = torch.zeros((n, b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    r, k, v, g, w = _rwkv_rkvgw(p, cfg, x, xs)
    u = p["bonus_u"]                                  # (N, H, hd)

    if use_kernel:
        fold = lambda t: t.reshape((n * b,) + t.shape[2:])
        u_seq = u[:, None].expand(n, b, h, hd).reshape(n * b, h, hd)
        y, state = rwkv_scan(fold(r), fold(k), fold(v), fold(w), u_seq,
                             fold(state))
        y = y.reshape(n, b, s, h, hd)
        state = state.reshape(n, b, h, hd, hd)
    else:
        uu = u.float()[:, None, :, :, None]           # (N, 1, H, hd, 1)
        ys = []
        for t in range(s):
            kv = torch.einsum("nbhk,nbhv->nbhkv", k[:, :, t].float(),
                              v[:, :, t].float())
            ys.append(torch.einsum("nbhk,nbhkv->nbhv", r[:, :, t].float(),
                                   state + uu * kv))
            state = w[:, :, t].float()[..., None] * state + kv
        y = torch.stack(ys, 2)                        # (N, B, S, H, hd)

    y = rmsnorm(p["ln_out"], y.reshape(n, b, s, d).to(x.dtype), cfg.norm_eps)
    y = y * F.silu(g.reshape(n, b, s, d))
    out = node_matmul(y, p["wo"].flatten(1, 2))
    return out, state, x[:, :, -1]


def rwkv_time_mix_decode(p, cfg, x, state, x_prev):
    """Single-token decode: x ``(N, B, 1, D)``; state ``(N, B, H, hd, hd)``;
    x_prev ``(N, B, D)``."""
    return rwkv_time_mix(p, cfg, x, state, x_prev)


def rwkv_channel_init(generator: torch.Generator, cfg, dtype, layers: int):
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    init = lambda shape: dense_init_on_device(generator, (layers,) + shape,
                                              dtype, stacked=1)
    return {
        "mu_k": torch.full((layers, d), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((layers, d), 0.5, dtype=dtype, device=dev),
        "wk": init((d, f)),
        "wv": init((f, d)),
        "wr": init((d, d)),
    }


def rwkv_channel_mix(p, x, x_prev=None):
    """RWKV channel-mix (the FFN analogue) with token shift, every node:
    x ``(N, B, S, D)``.  Returns (out, last x ``(N, B, D)``)."""
    if x_prev is None:
        x_prev = torch.zeros(x.shape[:2] + x.shape[-1:], dtype=x.dtype,
                             device=x.device)
    xs = _token_shift(x, x_prev)
    dx = xs - x
    xk = x + dx * _tail(p["mu_k"], x.ndim)
    xr = x + dx * _tail(p["mu_r"], x.ndim)
    v = node_matmul(torch.square(F.relu(node_matmul(xk, p["wk"]))), p["wv"])
    return torch.sigmoid(node_matmul(xr, p["wr"])) * v, x[:, :, -1]


# ======================================================================
# Mamba-style selective SSM (diagonal)
# ======================================================================
def mamba_init(generator: torch.Generator, cfg, dtype, layers: int):
    """Stacked ``(layers, ...)`` Mamba weights drawn on the generator's
    device, one leaf at a time.  ``dt_bias`` (zeros), ``log_a``
    (``log(1..n)`` broadcast over the ``di`` channels) and ``d_skip``
    (ones) are f32 in a bf16 model, as in the reference; ``log_a`` is
    the correctly rounded f32 log, which the reference's jitted init
    computes for ``n <= 16``."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    dev = generator.device
    init = lambda shape, scale=None: dense_init_on_device(
        generator, (layers,) + shape, dtype, scale=scale, stacked=1)
    log_n = torch.as_tensor(
        np.log(np.arange(1, n + 1, dtype=np.float64)).astype(np.float32),
        device=dev)
    f32 = lambda v: torch.full((layers, di), v, dtype=torch.float32,
                               device=dev)
    return {
        "w_in": init((d, 2 * di)),                      # x and gate z
        "conv_w": init((cfg.ssm_conv_dim, di), 0.2),
        "w_bcdt": init((di, 2 * n + 1)),                # B, C, Δ-rank1
        "dt_bias": f32(0.0),
        "log_a": log_n.expand(layers, di, n).clone(),   # A = -exp(log_a)
        "d_skip": f32(1.0),
        "w_out": init((di, d)),
    }


def _mamba_conv(p, x, conv_state=None):
    """Depthwise causal conv1d over time of every node: x ``(N, B, S,
    di)``; ``conv_state`` ``(N, B, kdim − 1, di)`` holds the inputs before
    position 0 (zeros when None).  The taps are summed in order, each
    product and sum in the activation type.  Returns (out, the last
    ``kdim − 1`` inputs: the next conv state)."""
    kdim = p["conv_w"].shape[1]
    n, b, s, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros((n, b, kdim - 1, di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=2)
    w = p["conv_w"][:, None, None]                      # (N, 1, 1, kdim, di)
    out = xp[:, :, 0:s] * w[:, :, :, 0]
    for i in range(1, kdim):
        out = out + xp[:, :, i:i + s] * w[:, :, :, i]
    return out, xp[:, :, -(kdim - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(−|x|))`` (torch's ``softplus`` takes ``log1p(exp(x))``)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _mamba_ssm_params(p, cfg, u):
    """u ``(N, B, S, di)`` → B, C ``(N, B, S, n)`` in the activation type;
    Δ ``(N, B, S, di)`` = softplus(Δ-rank1 + dt_bias) in f32; A = −exp(
    log_a) ``(N, di, n)`` f32."""
    n = cfg.ssm_state_dim
    bcdt = node_matmul(u, p["w_bcdt"])
    b_, c_, dt = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n:]
    dt = _softplus(dt.float() + _tail(p["dt_bias"], bcdt.ndim))
    a = -torch.exp(p["log_a"])
    return b_, c_, dt, a


def _mamba_scan(u, b_, c_, dt, a, h):
    """The recurrence over time, folded batch ``M = N·B``: u ``(M, S,
    di)``, B/C ``(M, S, n)``, Δ ``(M, S, di)``, A ``(M, di, n)``, h ``(M,
    di, n)`` f32.  Every step's ``dA = exp(Δ·A)`` and ``dBu = (Δ·B)·u``
    are elementwise in the inputs alone, so they are computed for all t
    before the loop, the same values as per step: two passes over the
    sequence where the reference's step makes five ops, leaving the loop
    one fused ``h ← dA·h + dBu`` a step.  They are laid out time-major,
    ``(S, M, di, n)`` in memory (their small inputs are transposed and
    copied first; an elementwise op keeps its input's layout), so each
    step reads two contiguous slices: one vectorized launch a step, where
    a slice strided over S spans gigabytes at S = 4096, past 32-bit
    offsets, and each ``addcmul`` splits in two strided launches.  Then
    ``y_t = Σ_n h_t·C_t`` for all t in one batched product.  Returns
    (y ``(M, S, di)`` f32, the final h)."""
    tm = lambda t: t.transpose(0, 1).contiguous()       # (S, M, ...)
    dt_t = tm(dt)[..., None]
    da = torch.exp(dt_t * a[None])                      # (S, M, di, n)
    dbu = (dt_t * tm(b_).float()[:, :, None, :]) * tm(u).float()[..., None]
    del dt_t
    hs = []
    for t in range(u.shape[1]):
        h = torch.addcmul(dbu[t], da[t], h)
        hs.append(h)
    del da, dbu
    y = torch.einsum("smdn,msn->msd", torch.stack(hs), c_.float())
    return y, h


def mamba_apply(p, cfg, x, ssm_state=None, conv_state=None):
    """Full-sequence Mamba of every node: x ``(N, B, S, d)``; states
    ``ssm_state`` ``(N, B, di, n)`` f32 and ``conv_state`` ``(N, B,
    kdim − 1, di)`` or None (zeros).  Returns (out ``(N, B, S, d)``,
    (ssm_state, conv_state))."""
    nn_, b, s, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_state_dim
    xz = node_matmul(x, p["w_in"])
    u, z = xz[..., :di], xz[..., di:]
    u, conv_state = _mamba_conv(p, u, conv_state)
    u = F.silu(u)
    b_, c_, dt, a = _mamba_ssm_params(p, cfg, u)
    if ssm_state is None:
        ssm_state = torch.zeros((nn_, b, di, n), dtype=torch.float32,
                                device=x.device)
    fold = lambda t: t.reshape((nn_ * b,) + t.shape[2:])
    a_m = a[:, None].expand(nn_, b, di, n).reshape(nn_ * b, di, n)
    y, h = _mamba_scan(fold(u), fold(b_), fold(c_), fold(dt), a_m,
                       fold(ssm_state))
    y = y.reshape(nn_, b, s, di).to(x.dtype) \
        + u * _tail(p["d_skip"].to(x.dtype), u.ndim)
    y = y * F.silu(z)
    return node_matmul(y, p["w_out"]), (h.reshape(nn_, b, di, n),
                                        conv_state)


def mamba_decode(p, cfg, x, ssm_state, conv_state):
    """Single-token decode: x ``(N, B, 1, d)``; states threaded
    explicitly."""
    return mamba_apply(p, cfg, x, ssm_state, conv_state)
