"""Causal latent-space attention of MLA (multi-head latent attention).

Port of the TPU kernel ``mla_attention_pallas`` in
``repro/kernels/mla_attention.py`` (body ``_kernel``): the prefill
attention of deepseek-v2's MLA (``ForwardOptions(attn_impl="pallas")`` on
an MLA config).  Keys and values are the same compressed latent
``c_kv``; ``k_rope`` is one rope key shared by all heads::

    logits = q_lat · c_kvᵀ + q_rope · k_ropeᵀ     (the caller pre-scales q)
    ctx    = softmax(logits masked to t <= s) · c_kv

:func:`mla_attention` launches one of two hand-written CUDA C++ kernels
in ``csrc/mla_attention.cu`` (what bounds each and what its design does
about it is noted there), built by ``kernels/build.py`` at first use and
called through ``ctypes``.  A bf16 latent goes to the tensor cores
(``mla_tc_kernel``: wgmma on bf16 tiles, an f32 q and p each split into
two bf16 pieces), an f32 one to the CUDA cores (``mla_kernel``).  It takes its plain PyTorch
version :func:`mla_attention_ref` (the port of ``repro/kernels/ref.py``
``mla_attention_ref``) only for tensors on the CPU; a CUDA tensor launches
its kernel or raises, and never falls back to the other kernel.
``mla_attention.launches`` counts the launches of either kernel (a plain
int); ``mla_attention.kernel_launches`` counts them by kernel name.  Both
are bumped at the one launch site, and a caller that resets one resets
the other.

Mask: latent row t is seen by query s where ``t <= s`` and ``t < T``, as
``mla_attention_ref`` has it.  The Pallas kernel masks ``t < S`` over its
zero-padded latent instead; the two agree whenever ``T = S``, its one
caller (prefill).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.layers import NEG_INF

__all__ = ["mla_attention", "mla_attention_ref", "kernel_for", "RANKS"]

RANKS = ((512, 64), (32, 16), (32, 8))   # the kernels' (r, dr) instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_cache = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        from repro_torch.kernels.build import load

        lib = load("mla_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mla_attention_launch.argtypes = [
            p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i,
            i, p]
        lib.mla_attention_launch.restype = ctypes.c_int
        lib.mla_tc_launch.argtypes = [
            p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i,
            i, i, p]
        lib.mla_tc_launch.restype = ctypes.c_int
        lib.mla_tc_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.mla_tc_tiles.restype = None
        _lib_cache.append(lib)
    return _lib_cache[0]


def mla_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch latent attention: f32 logits
    ``q_lat·c_kv + q_rope·k_rope``, the −1e30 causal mask ``t <= s`` over
    ``(S, T)``, a softmax and the weighted sum of ``c_kv``, cast to
    ``q_lat``'s type.  q_lat ``(B, S, H, r)``, q_rope ``(B, S, H, dr)``,
    c_kv ``(B, T, r)``, k_rope ``(B, T, dr)``.  It runs one sequence at a
    time, so the f32 logits it holds are ``H·S·T`` values (8.6 GB at
    deepseek-v2's 128 heads and S = T = 4096)."""
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    qi = torch.arange(s, device=q_lat.device)[:, None]
    ki = torch.arange(t, device=q_lat.device)[None, :]
    ok = ki <= qi
    out = torch.empty((b, s, h, r), dtype=q_lat.dtype, device=q_lat.device)
    for i in range(b):
        ck = c_kv[i].float()
        logits = torch.einsum("shr,tr->hst", q_lat[i].float(), ck)
        logits += torch.einsum("shk,tk->hst", q_rope[i].float(),
                               k_rope[i].float())
        probs = torch.softmax(logits.masked_fill_(~ok, NEG_INF), dim=-1)
        del logits
        out[i] = torch.einsum("hst,tr->shr", probs, ck).to(q_lat.dtype)
    return out


def _check(q_lat, q_rope, c_kv, k_rope) -> None:
    if q_lat.ndim != 4 or q_rope.ndim != 4 or c_kv.ndim != 3 \
            or k_rope.ndim != 3:
        raise ValueError(
            f"mla_attention: q_lat (B, S, H, r), q_rope (B, S, H, dr), c_kv "
            f"(B, T, r) and k_rope (B, T, dr) expected, got "
            f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
            f"{tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    b, s, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    if q_rope.shape[:3] != (b, s, h) or c_kv.shape[0] != b \
            or c_kv.shape[2] != r or k_rope.shape != (b, c_kv.shape[1], dr):
        raise ValueError(
            f"mla_attention: shapes do not match: q_lat {tuple(q_lat.shape)}"
            f", q_rope {tuple(q_rope.shape)}, c_kv {tuple(c_kv.shape)}, "
            f"k_rope {tuple(k_rope.shape)}")
    if s < 1 or c_kv.shape[1] < 1:
        raise ValueError("mla_attention: S and T must be at least 1")
    if q_lat.dtype != q_rope.dtype or c_kv.dtype != k_rope.dtype \
            or c_kv.dtype not in _DTYPE_CODES \
            or q_lat.dtype not in (torch.float32, c_kv.dtype):
        raise TypeError(
            f"mla_attention: c_kv and k_rope share one dtype, float32 or "
            f"bfloat16, and q_lat and q_rope share float32 or that dtype; "
            f"got {q_lat.dtype}, {q_rope.dtype}, {c_kv.dtype}, "
            f"{k_rope.dtype}")


def tc_tiles() -> tuple[int, int]:
    """``mla_tc_kernel``'s tiling, read from the built library: the query
    rows a block owns and the latent rows of a staged tile."""
    rows, keys = ctypes.c_int(), ctypes.c_int()
    _lib().mla_tc_tiles(ctypes.byref(rows), ctypes.byref(keys))
    return rows.value, keys.value


def kernel_for(c_kv: torch.Tensor) -> str:
    """The kernel a card call launches: ``"mla_tc_kernel"`` for a bf16
    latent, ``"mla_kernel"`` for an f32 one."""
    return "mla_tc_kernel" if c_kv.dtype == torch.bfloat16 else "mla_kernel"


def mla_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """Latent context ``(B, S, H, r)`` in q_lat's type, causal, of q_lat
    ``(B, S, H, r)`` and q_rope ``(B, S, H, dr)`` (pre-scaled by the
    caller) over c_kv ``(B, T, r)`` and k_rope ``(B, T, dr)``.  On the
    card: (r, dr) one of :data:`RANKS`, c_kv and k_rope f32 or bf16, q
    f32 or their type, each tensor's last dimension contiguous (the rest
    is read through the strides), every latent row on a 16-byte boundary.
    The rule (:func:`kernel_for`): a bf16 latent launches
    ``mla_tc_kernel`` (bf16 tensor-core products with f32 sums, an f32 q
    and p each as two bf16 pieces), an f32 one ``mla_kernel`` (f32
    arithmetic)."""
    _check(q_lat, q_rope, c_kv, k_rope)
    if q_lat.device.type == "cpu":
        return mla_attention_ref(q_lat, q_rope, c_kv, k_rope)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_attention runs on cuda or cpu, got "
                         f"{q_lat.device}")
    b, s, h, r = q_lat.shape
    t, dr = c_kv.shape[1], k_rope.shape[-1]
    if (r, dr) not in RANKS:
        raise ValueError(f"mla_attention: (r, dr) = ({r}, {dr}) has no "
                         f"kernel instantiation (have {RANKS})")
    if any(x.device != q_lat.device for x in (q_rope, c_kv, k_rope)):
        raise ValueError("mla_attention: every input must be on one device")
    if any(x.stride(-1) != 1 for x in (q_lat, q_rope, c_kv, k_rope)):
        raise ValueError("mla_attention: the last dimension of q_lat, "
                         "q_rope, c_kv and k_rope must be contiguous")
    per = 16 // c_kv.element_size()
    if any(x.data_ptr() % 16 or x.stride(0) % per or x.stride(1) % per
           for x in (c_kv, k_rope)):
        raise ValueError("mla_attention: every row of c_kv and k_rope must "
                         "start on a 16-byte boundary (the kernel stages "
                         "them with 16-byte loads)")
    if b > 65535 or h > 65535:
        raise ValueError(f"mla_attention: B={b} and H={h} must be <= 65535 "
                         f"(grid limit)")
    out = torch.empty((b, s, h, r), dtype=q_lat.dtype, device=q_lat.device)
    strides = (ctypes.c_longlong * 13)(
        *(st for x in (q_lat, q_rope, out) for st in x.stride()[:3]),
        *(st for x in (c_kv, k_rope) for st in x.stride()[:2]))
    kernel = kernel_for(c_kv)
    ptrs = (q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
            k_rope.data_ptr(), out.data_ptr(), strides)
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream(q_lat.device).cuda_stream
        if kernel == "mla_tc_kernel":
            rc = _lib().mla_tc_launch(*ptrs, _DTYPE_CODES[q_lat.dtype], b, s,
                                      t, h, r, dr, stream)
        else:
            rc = _lib().mla_attention_launch(*ptrs, b, s, t, h, r, dr,
                                             stream)
    if rc != 0:
        raise RuntimeError(f"mla_attention: {kernel} launch failed: "
                           f"cudaError {rc}")
    mla_attention.launches += 1
    mla_attention.kernel_launches[kernel] += 1
    return out


mla_attention.launches = 0
mla_attention.kernel_launches = {"mla_tc_kernel": 0, "mla_kernel": 0}
