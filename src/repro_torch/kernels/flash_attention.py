"""Causal flash attention with GQA, a sliding window and a logit softcap.

Port of the TPU kernel ``flash_attention_pallas`` in
``repro/kernels/flash_attention.py`` (body ``_kernel``): the prefill
attention of the dense transformer stack (``ForwardOptions(attn_impl=
"pallas")``).  :func:`flash_attention` launches one of two hand-written
CUDA C++ kernels in ``csrc/flash_attention.cu``, chosen by the input type:
bf16 goes to the tensor cores (``flash_tc_kernel``: wgmma on bf16 tiles
staged by ``cp.async``, p split into bf16 pieces for P·V), f32 to the
CUDA cores (``flash_kernel``); what bounds each and what its design does
about it is noted there.  They are built by ``kernels/build.py`` at first
use and called through ``ctypes``.  The wrapper takes its plain PyTorch
version :func:`flash_attention_ref` (the port of ``repro/kernels/ref.py``
``flash_attention_ref``) only for tensors on the CPU; a CUDA tensor
launches a kernel or raises.  ``flash_attention.launches`` counts the
launches of either kernel (a plain int, reset by the caller),
``flash_attention.shapes`` the same launches by shape and dtype.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.models.layers import NEG_INF

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 96, 128)   # the kernel's instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_cache = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        from repro_torch.kernels.build import load

        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i,
            i, i, ctypes.c_float, ctypes.c_float, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch attention: f32 logits ``q·k / √hd``, the cap, the
    −1e30 mask, a softmax and the weighted sum of v, cast back to q's
    type.  q ``(B, S, H, hd)``; k/v ``(B, S, KV, hd)``.  It runs one kv
    head (its g = H / KV query heads) at a time, so the f32 logits it
    holds are ``B·g·S²`` values (0.5 GB at the gemma2 shape, S = 8192)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    out = torch.empty_like(q)
    for j in range(kvh):
        heads = slice(j * g, (j + 1) * g)
        logits = torch.einsum("bsgh,bth->bgst", q[:, :, heads].float(),
                              k[:, :, j].float()) / math.sqrt(hd)
        if logit_softcap > 0:
            logits = torch.tanh(logits / logit_softcap) * logit_softcap
        logits = logits.masked_fill(~ok, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out[:, :, heads] = torch.einsum(
            "bgst,bth->bsgh", probs, v[:, :, j].float()).to(q.dtype)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, S, H, hd) and k, v "
                         f"(B, S, KV, hd) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"KV={k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _check_rows_aligned(*tensors: torch.Tensor) -> None:
    """The bf16 kernel copies q, k and v rows 16 bytes at a time: each
    base must be 16-byte aligned and each batch, seq and head stride (of
    a dimension longer than 1) a multiple of 8 elements."""
    for name, t in zip("qkv", tensors):
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"flash_attention: bf16 {name} must have a 16-byte-aligned "
                f"base and (batch, seq, head) strides that are multiples of "
                f"8; got base % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride()[:3])}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """Attention of q ``(B, S, H, hd)`` over k, v ``(B, S, KV, hd)``:
    causal (or not), keys within ``window`` of the query when
    ``window > 0``, logits capped at ``logit_softcap`` when it is > 0.
    f32 or bf16 in, the same type out, f32 logits, softmax and sums.  On
    the card, hd must be 32, 64, 96 or 128 and each tensor's last dimension
    contiguous; bf16 inputs also need 16-byte-aligned rows
    (:func:`_check_rows_aligned`)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                         f"instantiation (have {HEAD_DIMS})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension of q, k and v "
                         "must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q, k, v)
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: B={b} and H={h} must be "
                         f"<= 65535 (grid limit)")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, _DTYPE_CODES[q.dtype], b, s, h, k.shape[2], hd,
            int(causal), int(window), float(logit_softcap),
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.shapes[(b, s, h, k.shape[2], hd, str(q.dtype)[6:])] += 1
    return out


flash_attention.launches = 0
flash_attention.shapes = collections.Counter()
