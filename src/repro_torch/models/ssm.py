"""RWKV-6 ("Finch") time-mix and channel-mix (port of the RWKV half of
``repro/models/ssm.py``).

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
is what decode runs.  The Mamba half of the reference module is not
ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Tuple

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
