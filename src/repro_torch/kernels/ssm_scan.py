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
kernel or raises.  :func:`scan_plan` lays out the launch: how many state
columns a block owns, and so how many blocks share each head.
``rwkv_scan.launches`` counts kernel launches (a plain int, reset by the
caller), ``rwkv_scan.shapes`` the same launches by ``(B, S, H, hd,
dtype)``, ``rwkv_scan.calls`` every call, CPU or CUDA
(``_trace.kernel_entry``).

``u`` is the reference's ``(H, hd)`` bonus, or ``(B, H, hd)``: one bonus
per sequence, so that a fleet's nodes, each with its own ``bonus_u``, run
in one launch with the node axis folded into the batch.
"""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass

import torch

from repro_torch._trace import kernel_entry

__all__ = ["rwkv_scan", "rwkv_scan_ref", "HEAD_DIMS", "ScanPlan",
           "scan_plan"]

HEAD_DIMS = (32, 64)   # the kernel's instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_cache = []

# csrc/ssm_scan.cu's constants: state rows and columns a thread, time
# steps a chunk, ring stages, and the columns a block may own
ROWS_PER_THREAD = 8
COLS_PER_THREAD = 2
CHUNK_STEPS = 16
STAGES = 3
COL_BLOCKS = (8, 16, 32)
MIN_THREADS = 64          # two warps a block at least
# Hopper: shared bytes an SM and a block, the runtime's share of each
# block; threads and blocks an SM; registers an SM, and a thread's of this
# kernel at most (ptxas gives its instantiations 102 to 159)
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1024
THREADS_PER_SM, BLOCKS_PER_SM = 2048, 32
REGS_PER_SM, MAX_REGS = 65_536, 160


@dataclass(frozen=True)
class ScanPlan:
    """How ``rwkv_kernel`` runs a ``(B, S, H, hd)`` scan: the grid is
    ``(groups, H, B)``; a block owns ``col_block`` state columns of one
    head (``groups = hd / col_block``) in ``threads`` threads, each with
    ``ROWS_PER_THREAD`` rows of ``COLS_PER_THREAD`` columns, and
    ``smem_bytes`` of dynamic shared memory (the ring of raw inputs, the
    f32 work tiles, the y tile)."""

    col_block: int
    threads: int
    smem_bytes: int
    groups: int
    blocks_per_sm: int

    def c_args(self):
        """The plan as the C entry takes it."""
        return (ctypes.c_longlong * 4)(self.col_block, self.threads,
                                       self.smem_bytes, self.groups)


def _smem_bytes(hd: int, col_block: int, itemsize: int) -> int:
    """csrc/ssm_scan.cu ``Shape::SMEM``."""
    stage = CHUNK_STEPS * (2 * hd * itemsize + hd * 4 + col_block * itemsize)
    work = (2 * CHUNK_STEPS * hd + CHUNK_STEPS * col_block + CHUNK_STEPS) * 4
    return STAGES * stage + work + CHUNK_STEPS * col_block * 4


def _threads(hd: int, col_block: int, rows: int = ROWS_PER_THREAD,
             cols: int = COLS_PER_THREAD):
    """csrc/ssm_scan.cu ``Shape::NT`` for a thread tile of ``rows`` x
    ``cols`` state elements, or None where the kernel has no such block
    (not whole warps, or a prep pass that does not divide)."""
    parts = hd // rows
    threads = col_block // cols * parts
    q = threads // CHUNK_STEPS
    steps = parts // cols
    ok = (threads % 32 == 0 and threads <= 1024 and 1 <= q <= 32
          and hd % q == 0 and (hd // q) % 4 == 0 and steps >= 1
          and CHUNK_STEPS % steps == 0 and col_block % cols == 0)
    return threads if ok else None


def scan_plan(b: int, h: int, hd: int, dtype: torch.dtype,
              sms: int) -> ScanPlan:
    """The launch plan of ``rwkv_kernel`` for ``B = b`` sequences of ``h``
    heads of ``hd`` channels, r/k/v in ``dtype``, on a card with ``sms``
    SMs.

    Of the column blocks 8, 16 and 32 whose blocks are at least two warps
    (a one-warp block stalls whole at its prep pass and barriers:
    ``benchmarks.kernel_split`` measured 8 columns, one warp, 1.58× slower
    than 16 at the rwkv6-3b prefill), the one that gives the most loaded
    SM the fewest threads to run: an SM runs ⌈blocks / sms⌉ blocks, in
    one wave where they fit it together, else in waves of the blocks that
    fit (each thread walks the whole sequence, so an SM's time follows
    its threads).  On a tie the wider block, which stages r, k and w
    fewer times over.  The rwkv6-3b prefill (2, 4096, 40, 64): 16 columns
    (320 blocks of 64 threads, three an SM)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"scan_plan: head dim {hd} has no kernel "
                         f"instantiation (have {HEAD_DIMS})")
    if b < 1 or h < 1:
        raise ValueError(f"scan_plan needs B, H >= 1, got {b}, {h}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"scan_plan takes float32 or bfloat16, got {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    best = None
    for cb in COL_BLOCKS:
        threads = _threads(hd, cb)
        if threads is None or threads < MIN_THREADS:
            continue
        smem = _smem_bytes(hd, cb, itemsize)
        bps = min(BLOCKS_PER_SM, THREADS_PER_SM // threads,
                  REGS_PER_SM // (threads * MAX_REGS),
                  SMEM_PER_SM // (smem + SMEM_RESERVED))
        if smem > SMEM_PER_BLOCK or bps < 1:
            continue
        per_sm = -(-b * h * (hd // cb) // sms)
        waves = -(-per_sm // bps)
        load = (per_sm if waves == 1 else waves * bps) * threads
        if best is None or load <= best[0]:
            best = (load, ScanPlan(cb, threads, smem, hd // cb, bps))
    return best[1]


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        from repro_torch.kernels.build import load

        lib = load("ssm_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_scan_launch.argtypes = [
            p, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i,
            i, i, i, ctypes.POINTER(ctypes.c_longlong), p]
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


@kernel_entry("rwkv_scan")
def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """The RWKV-6 recurrence over ``(B, S, H, hd)`` inputs from ``state``
    ``(B, H, hd, hd)``: returns (y in r's dtype, the final state f32).
    f32 arithmetic.  On the card: r, k, v f32 or bf16, w, u and state f32,
    hd 32 or 64, each input's last dimension contiguous and every row of
    r, k, v and w 16-byte aligned (they are read in place through their
    other strides)."""
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
    if b > 65535 or h > 65535:
        raise ValueError(f"rwkv_scan: B={b} and H={h} must be <= 65535 "
                         f"(grid limit)")
    for name, t in zip("rkvw", (r, k, v, w)):
        if t.data_ptr() % 16 or any(
                st * t.element_size() % 16
                for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(
                f"rwkv_scan: every row of {name} must start on a 16-byte "
                f"boundary (base address {t.data_ptr():#x}, strides "
                f"{t.stride()[:3]} of {t.element_size()} bytes); the kernel "
                f"stages rows with 16-byte copies")
    state = state.contiguous()
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    u_strides = (0, u.stride(0)) if u.ndim == 2 else u.stride()[:2]
    strides = (ctypes.c_longlong * 17)(
        *(st for t in (r, k, v, w, y) for st in t.stride()[:3]), *u_strides)
    index = r.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = scan_plan(b, h, hd, r.dtype, torch.cuda.get_device_properties(
        index).multi_processor_count)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _lib().rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), final.data_ptr(),
            strides, _DTYPE_CODES[r.dtype], b, s, h, hd, plan.c_args(),
            stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_scan kernel launch failed: cudaError {rc}")
    rwkv_scan.launches += 1
    rwkv_scan.shapes[(b, s, h, hd, str(r.dtype)[6:])] += 1
    return y, final


rwkv_scan.launches = 0
rwkv_scan.shapes = collections.Counter()
