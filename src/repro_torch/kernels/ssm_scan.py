"""The RWKV-6 recurrence (data-dependent-decay linear attention).

Port of the TPU kernel ``rwkv_scan_pallas`` in ``repro/kernels/ssm_scan.py``
(body ``_kernel``): the time-mix scan of the RWKV-6 family
(``ForwardOptions(use_ssm_kernel=True)``).  Per batch b and head h, with
the ``(hd, hd)`` f32 state S (rows indexed by k's channel, columns by
v's)::

    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

:func:`rwkv_scan` launches the hand-written CUDA C++ kernel in
``csrc/ssm_scan.cu`` (what bounds it and what the design does about it is
noted there), built by ``kernels/build.py`` at first use and called
through ``ctypes``.  It takes its plain PyTorch version
:func:`rwkv_scan_ref` (the port of ``repro/kernels/ref.py``
``rwkv_scan_ref``) only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.  ``rwkv_scan.launches`` counts kernel launches (a plain
int, reset by the caller).

``u`` is the reference's ``(H, hd)`` bonus, or ``(B, H, hd)``: one bonus
per sequence, so that a fleet's nodes, each with its own ``bonus_u``, run
in one launch with the node axis folded into the batch.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["rwkv_scan", "rwkv_scan_ref", "HEAD_DIMS"]

HEAD_DIMS = (32, 64)   # the kernel's instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_cache = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        from repro_torch.kernels.build import load

        lib = load("ssm_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_scan_launch.argtypes = [
            p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i,
            i, i, i, p]
        lib.rwkv_scan_launch.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _bonus(u: torch.Tensor) -> torch.Tensor:
    """``(H, hd)`` or ``(B, H, hd)`` → ``(1 | B, H, hd, 1)`` f32."""
    return (u if u.ndim == 3 else u[None]).float()[..., None]


def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The sequential recurrence in f32, one step at a time (the ground
    truth).  r, k, v, w ``(B, S, H, hd)``; u ``(H, hd)`` or ``(B, H, hd)``;
    state ``(B, H, hd, hd)``.  Returns (y ``(B, S, H, hd)`` in r's dtype,
    the final state f32)."""
    uu = _bonus(u)
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               s + uu * kv))
        s = w[:, t].float()[..., None] * s + kv
    return torch.stack(ys, 1).to(r.dtype), s


def _check(r, k, v, w, u, state) -> None:
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv_scan: r, k, v, w must share one (B, S, H, "
                         f"hd) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, s, h, hd = r.shape
    if s < 1:
        raise ValueError("rwkv_scan: the sequence is empty")
    if u.shape not in ((h, hd), (b, h, hd)):
        raise ValueError(f"rwkv_scan: u must be (H, hd) or (B, H, hd) = "
                         f"{(h, hd)} or {(b, h, hd)}, got {tuple(u.shape)}")
    if state.shape != (b, h, hd, hd):
        raise ValueError(f"rwkv_scan: state must be (B, H, hd, hd) = "
                         f"{(b, h, hd, hd)}, got {tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODES:
        raise TypeError(f"rwkv_scan: r, k, v must share one dtype, float32 "
                        f"or bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The RWKV-6 recurrence over ``(B, S, H, hd)`` inputs from ``state``
    ``(B, H, hd, hd)``: returns (y in r's dtype, the final state f32).
    f32 arithmetic.  On the card: r, k, v f32 or bf16, w, u and state f32,
    hd 32 or 64, each input's last dimension contiguous (r, k, v and w are
    read in place through their other strides)."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv_scan_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan runs on cuda or cpu, got {r.device}")
    b, s, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan: head dim {hd} has no kernel "
                         f"instantiation (have {HEAD_DIMS})")
    if any(t.device != r.device for t in (k, v, w, u, state)):
        raise ValueError("rwkv_scan: every input must be on one device")
    if any(t.dtype != torch.float32 for t in (w, u, state)):
        raise TypeError(f"rwkv_scan: w, u and state must be float32, got "
                        f"{w.dtype}, {u.dtype}, {state.dtype}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w, u)):
        raise ValueError("rwkv_scan: the head dimension of r, k, v, w and u "
                         "must be contiguous")
    if b > 65535:
        raise ValueError(f"rwkv_scan: B={b} must be <= 65535 (grid limit)")
    state = state.contiguous()
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    u_strides = (0, u.stride(0)) if u.ndim == 2 else u.stride()[:2]
    strides = (ctypes.c_longlong * 17)(
        *(st for t in (r, k, v, w, y) for st in t.stride()[:3]), *u_strides)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _lib().rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), final.data_ptr(),
            strides, _DTYPE_CODES[r.dtype], b, s, h, hd, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_scan kernel launch failed: cudaError {rc}")
    rwkv_scan.launches += 1
    return y, final


rwkv_scan.launches = 0
