"""Gossip mix kernels: Eq. (2) over the packed ``(n, P)`` parameter plane.

Port of the three TPU kernels on the trainer's path in
``repro/kernels/gossip_mix.py``:

* :func:`gossip_plane` replaces ``gossip_plane_pallas`` (body
  ``_plane_kernel``): ``out = C @ plane``, f32 accumulation
  (``mix_impl="pallas"``);
* :func:`gossip_edges` replaces ``gossip_edges_pallas`` (body
  ``_edges_kernel``): ``out[i] = Σ_d w[i, d] · plane[idx[i, d]]`` over
  padded-ELL tables, f32 accumulation in ascending d (``mix_impl="edges"``);
* :func:`gossip_robust` replaces ``gossip_robust_pallas`` (body
  ``_robust_kernel``): the coordinate-wise trimmed mean or median of
  ``core.mixing.robust_combine`` over the same tables
  (``mix_impl="edges"`` with ``robust="trimmed"`` or ``"median"``);
* :func:`gossip_mix` replaces the legacy K-way MAC ``gossip_mix_pallas``
  (body ``_kernel``): ``out[r] = Σ_k w[r, k] · blocks[k]`` over
  ``(K, M, N)`` blocks.  :func:`mix_dense_rows` is its per-leaf fan-out,
  the counterpart of ``mix_dense_pallas``: the mix-cost study's baseline
  (``benchmarks.gossip_cost.run_mix``), selected by no ``mix_impl``.

They are hand-written CUDA C++ for Hopper in ``csrc/gossip_mix.cu`` and
``csrc/gossip_robust.cu`` (what bounds them and what the design does
about it is noted there), built by ``kernels/build.py`` at first use and
called through ``ctypes``.  :func:`gossip_plane` and the 16-byte path of
:func:`gossip_mix` run one streaming kernel, ``out (R, L) = W (R, K) · X
(K, L)``, whose launch :func:`mix_plan` lays out.  Each wrapper takes its
plain PyTorch version (``gossip_plane_ref``, ``gossip_edges_ref``,
``gossip_robust_ref``, ``gossip_mix_ref``) only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches (plain ints, reset by the
caller), ``<wrapper>.shapes`` the same launches by operand shape and
dtype.

The experiment axis: :func:`gossip_plane`, :func:`gossip_edges` and
:func:`gossip_robust` also take the sweep engine's E experiments at once
— a plane ``(E, n, P)`` (a view of one ``(E·n, P)`` allocation of row
stride ``ld``, as :meth:`PlaneLayout.pack` makes it for the folded tree),
coefficients ``(E, n, n)`` or weights ``(E, n, dmax)`` against ONE shared
``(n, dmax)`` table — in one launch whose grid carries the experiment
index; the reference runs its kernels under ``jax.vmap`` over the
experiments, which gives a ``pallas_call`` the same batch axis.  Each
output row sums its sources in the same order whatever E is, so a batched
launch equals E single launches bit for bit; the plain versions take the
same operands and are E plain calls.  The ``.shapes`` key of a batched
launch leads with ``"E=<E>"``.

:func:`mix_plane`, :func:`mix_edges_kernel` and :func:`mix_robust_kernel`
are the tree-level wrappers the trainer calls: pack once → one launch →
unpack once; with ``(E, n, n)`` coefficients they take ``(E, n, ...)``
trees and still pack, launch and unpack once for the whole grid.
:func:`mix_modeled_hbm_bytes` is the reference's byte model of one mix
for every backend.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core.mixing import edge_weights, robust_combine
from repro_torch.core.plane import PlaneLayout

__all__ = [
    "gossip_plane",
    "gossip_plane_ref",
    "gossip_edges",
    "gossip_edges_ref",
    "gossip_robust",
    "gossip_robust_ref",
    "mix_plane",
    "mix_edges_kernel",
    "mix_robust_kernel",
    "gossip_mix",
    "gossip_mix_ref",
    "mix_dense_rows",
    "mix_modeled_hbm_bytes",
    "MixPlan",
    "mix_plan",
    "RobustPlan",
    "robust_plan",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = {}


def _lib(name: str = "gossip_mix") -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` with its argtypes set."""
    lib = _bound.get(name)
    if lib is None:
        from repro_torch.kernels.build import load

        lib = load(name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "gossip_mix":
            plan = ctypes.POINTER(ll)
            lib.gossip_plane_launch.argtypes = [p, p, p, i, ll, ll, i, i, i,
                                                p, plan]
            lib.gossip_plane_launch.restype = ctypes.c_int
            lib.gossip_edges_launch.argtypes = [p, p, p, p, i, i, ll, ll, i,
                                                i, i, p]
            lib.gossip_edges_launch.restype = ctypes.c_int
            lib.gossip_mix_launch.argtypes = [p, p, p, i, i, ll, ll, ll, ll,
                                              i, p, plan]
            lib.gossip_mix_launch.restype = ctypes.c_int
        else:
            lib.gossip_robust_launch.argtypes = [p, p, p, p, i, i, ll, ll, i,
                                                 i, i, i, i,
                                                 ctypes.POINTER(ll), p]
            lib.gossip_robust_launch.restype = ctypes.c_int
        _bound[name] = lib
    return lib


def _check_plane(plane: torch.Tensor) -> None:
    if plane.ndim not in (2, 3):
        raise ValueError(f"plane must be (n, P) or (E, n, P), got "
                         f"{tuple(plane.shape)}")
    if plane.dtype not in _DTYPE_CODES:
        raise TypeError(f"plane dtype must be float32 or bfloat16, got "
                        f"{plane.dtype}")


def _rows_view(plane: torch.Tensor, name: str) -> torch.Tensor:
    """The ``(E·n, P)`` view of an ``(E, n, P)`` CUDA plane (the plane
    itself when 2-D): the experiments' rows must be one allocation of one
    row stride, which the kernels walk as E blocks of n rows."""
    if plane.ndim == 2:
        return plane
    e, n, p = plane.shape
    try:
        return plane.view(e * n, p)
    except RuntimeError:
        raise ValueError(
            f"{name}: an (E, n, P) plane must be one (E·n, P) allocation "
            f"of one row stride (PlaneLayout.pack of the folded tree), got "
            f"strides {plane.stride()}") from None


def _shape_key(plane: torch.Tensor, *extra):
    """The ``.shapes`` key: ``(n, P, dtype, ...)``, led by ``"E=<E>"`` for
    a batched launch."""
    key = (plane.shape[-2], plane.shape[-1], str(plane.dtype)[6:]) + extra
    return (f"E={plane.shape[0]}",) + key if plane.ndim == 3 else key


def _check_cuda_plane(plane: torch.Tensor, name: str) -> int:
    """Row stride ``ld`` of a CUDA plane the kernels can take: rows
    contiguous, row stride ≥ P, base address and row stride 16-byte
    aligned (the kernels read and write 16-byte vectors; ``aligned_plane``
    and ``PlaneLayout.pack`` make such planes)."""
    n, p = plane.shape
    if plane.stride(1) != 1 and p > 1:
        raise ValueError(f"{name}: plane rows must be contiguous")
    b = plane.element_size()
    ld = plane.stride(0) if n > 1 else -(-max(p, 1) * b // 16) * 16 // b
    if ld < p:
        raise ValueError(f"{name}: plane row stride {ld} < P={p}")
    if (ld * b) % 16 or plane.data_ptr() % 16:
        raise ValueError(
            f"{name}: plane rows must start on 16-byte boundaries (row "
            f"stride {ld * b} B, base address {plane.data_ptr():#x}); "
            f"build it with core.plane.aligned_plane or PlaneLayout.pack")
    return ld


def _out_like(plane: torch.Tensor, ld: int) -> torch.Tensor:
    *lead, p = plane.shape
    return torch.empty(tuple(lead) + (ld,), dtype=plane.dtype,
                       device=plane.device)[..., :p]


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ----------------------------------------------------------------------
# the streaming kernel's launch plan (csrc/gossip_mix.cu stream_kernel)
# ----------------------------------------------------------------------
VEC_BYTES = 16           # one copy, one load: a thread's 16-byte vector
ROWS_PER_THREAD = 11     # output rows a thread (kRpt): n = 33 is 3 groups
GROUP_THREADS = 64       # threads a row group, 1 or 2 vectors each
MAX_GROUPS = 6           # row groups a block (kMaxGroups)
MAX_BLOCK_ROWS = 64      # output rows a block; more rows take row blocks
MAX_CHUNK = 48           # source rows a ring stage
MAX_STAGE_ROW_BYTES = 64 * 1024   # a stage's source-row bytes
MAX_STAGES = 8           # ring stages (kMaxStages)
W_RESIDENT_BYTES = 64 * 1024   # C's bytes a block keeps for its whole life
# Hopper: shared bytes an SM and a block, the runtime's share of each block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1024
REGS_PER_SM, THREADS_PER_SM, BLOCKS_PER_SM = 65_536, 2048, 32
# registers a thread at most: __launch_bounds__(384, 1) lets ptxas use
# 65,536 / 384 rounded down to 8
MAX_REGS = 168


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MixPlan:
    """How ``stream_kernel`` runs ``out (R, L) = W (R, K) · X (K, L)``.

    Block ``b`` owns output rows ``(b % row_blocks) · rows_per_block`` on
    (``rows_per_block`` of them, fewer in the last row block) and walks
    the column tiles ``b // row_blocks``, ``+ lanes``, … (``lanes = grid /
    row_blocks``), ``tile_cols`` columns (``vecs`` KB a row) each.  Its
    ``groups · 64`` threads hold ``ROWS_PER_THREAD`` rows each of
    ``vecs`` 16-byte column vectors.  Source rows come in ``chunks`` of
    ``chunk`` (the last may be shorter), one ring stage each, ``stages``
    stages.  C's rows of the block stay in shared memory when
    ``w_resident``, else each stage carries its chunk's slice.  The grid
    runs ``grid`` blocks an experiment (its x extent) for ``experiments``
    experiments (its y extent)."""

    itemsize: int
    rows_per_block: int
    row_blocks: int
    groups: int
    chunk: int
    chunks: int
    stages: int
    w_resident: bool
    grid: int
    smem_bytes: int
    vecs: int
    blocks_per_sm: int
    experiments: int = 1

    @property
    def row_bytes(self) -> int:
        """A tile's bytes of one source row."""
        return self.vecs * GROUP_THREADS * VEC_BYTES

    @property
    def tile_cols(self) -> int:
        return self.row_bytes // self.itemsize

    @property
    def threads(self) -> int:
        return self.groups * GROUP_THREADS

    @property
    def slots(self) -> int:
        """Output rows a block computes; those past its rows are dropped."""
        return self.groups * ROWS_PER_THREAD

    @property
    def x_stage_bytes(self) -> int:
        return self.chunk * self.row_bytes

    @property
    def w_stage_bytes(self) -> int:
        return 0 if self.w_resident else self.slots * _round4(self.chunk) * 4

    def w_bytes(self, n_src: int) -> int:
        return self.slots * _round4(n_src) * 4 if self.w_resident else 0

    def c_args(self):
        """The plan as the C entries take it (``StreamPlan``'s order)."""
        return (ctypes.c_longlong * 11)(
            self.rows_per_block, self.row_blocks, self.groups, self.chunk,
            self.chunks, self.stages, int(self.w_resident), self.grid,
            self.smem_bytes, self.vecs, self.experiments)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _blocks_per_sm(threads: int, smem: int) -> int:
    warp_regs = MAX_REGS * 32
    return min(BLOCKS_PER_SM, THREADS_PER_SM // threads,
               REGS_PER_SM // (threads // 32 * warp_regs),
               SMEM_PER_SM // (smem + SMEM_RESERVED))


def mix_plan(n_rows: int, n_src: int, p: int, dtype: torch.dtype,
             sms: int, experiments: int = 1) -> MixPlan:
    """The launch plan of ``stream_kernel`` for ``n_rows`` output rows
    (R), ``n_src`` source rows (K) and ``p`` columns (L) of ``dtype``
    (f32 or bf16) on a card with ``sms`` SMs, for each of ``experiments``
    experiments.

    Output rows: one row block for R ≤ 64, else balanced blocks of ≤ 64;
    ⌈rows / 11⌉ row groups (n = 33: 3 groups of 11, no idle warp).  A
    thread takes one 16-byte column vector, or two in f32 when R > 64,
    where the mix is bound by operations and a thread's 8 columns halve
    the shared-memory reads a multiply-add.  Source rows: one chunk for
    K ≤ 48 and ≤ 64 KB a stage, else balanced chunks of a multiple of 4.
    C stays resident when the block's rows of it fit 64 KB.  Stages: of
    the counts in 3…8, those that let the most blocks share an SM (their
    warps hide each other's arithmetic and barriers), and of those the one
    that keeps the most source bytes in flight on it (blocks × ``stages −
    1`` stages), the fewest on a tie.  Grid: the SM count times those
    blocks, a multiple of the row blocks, and no more lanes than column
    tiles; with E experiments the SMs' blocks are shared among E × the
    row blocks (at least one lane each), so ``experiments=1`` is the
    single-experiment plan exactly."""
    if experiments < 1:
        raise ValueError(f"mix_plan needs experiments >= 1, got "
                         f"{experiments}")
    if n_rows < 1 or n_src < 1 or p < 0:
        raise ValueError(f"mix_plan needs R, K >= 1 and L >= 0, got "
                         f"{n_rows}, {n_src}, {p}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"mix_plan takes float32 or bfloat16, got {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    row_blocks = _cdiv(n_rows, MAX_BLOCK_ROWS)
    rows_per_block = _cdiv(n_rows, row_blocks)
    groups = _cdiv(rows_per_block, ROWS_PER_THREAD)
    vecs = 2 if itemsize == 4 and n_rows > MAX_BLOCK_ROWS else 1
    row_bytes = vecs * GROUP_THREADS * VEC_BYTES
    chunks = _cdiv(n_src, min(MAX_CHUNK, MAX_STAGE_ROW_BYTES // row_bytes))
    chunk = n_src if chunks == 1 else _round4(_cdiv(n_src, chunks))
    chunks = _cdiv(n_src, chunk)
    slots = groups * ROWS_PER_THREAD
    w_resident = slots * _round4(n_src) * 4 <= W_RESIDENT_BYTES
    w_bytes = slots * _round4(n_src) * 4 if w_resident else 0
    stage = chunk * row_bytes + (0 if w_resident
                                 else slots * _round4(chunk) * 4)
    threads = groups * GROUP_THREADS
    best = None
    for stages in range(3, MAX_STAGES + 1):
        smem = w_bytes + stages * stage
        if smem > SMEM_PER_BLOCK:
            break
        bps = _blocks_per_sm(threads, smem)
        key = (bps, bps * (stages - 1) * stage)
        if bps and (best is None or key > best[0]):
            best = (key, stages, smem)
    if best is None:
        raise ValueError(f"mix_plan: no ring fits shared memory for R="
                         f"{n_rows}, K={n_src}")
    (bps, _), stages, smem = best
    n_tiles = _cdiv(p, row_bytes // itemsize)
    lanes = max(1, min(n_tiles, sms * bps // (row_blocks * experiments)))
    return MixPlan(itemsize, rows_per_block, row_blocks, groups, chunk,
                   chunks, stages, w_resident, lanes * row_blocks, smem,
                   vecs, bps, experiments)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_args(n_rows: int, n_src: int, p: int, t: torch.Tensor,
               experiments: int = 1):
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return mix_plan(n_rows, n_src, p, t.dtype, _sm_count(index),
                    experiments).c_args()


# ----------------------------------------------------------------------
# fused flat-plane mix
# ----------------------------------------------------------------------
def gossip_plane_ref(plane: torch.Tensor, coeffs: torch.Tensor,
                     mix_in_float32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`gossip_plane`.

    f32 accumulation: ``C.float() @ plane.float()`` cast back.  With
    ``mix_in_float32=False`` on a bf16 plane the sum runs in bf16 in
    ascending source row: C, each product and each partial sum rounded to
    bf16 (the kernel's arithmetic, op for op).  ``(E, n, P)`` with ``(E,
    n, n)``: each experiment's own call."""
    if plane.ndim == 3:
        return torch.stack([gossip_plane_ref(plane[e], coeffs[e],
                                             mix_in_float32)
                            for e in range(plane.shape[0])])
    if mix_in_float32 or plane.dtype == torch.float32:
        return (coeffs.float() @ plane.float()).to(plane.dtype)
    c = coeffs.to(plane.dtype)
    acc = torch.zeros(plane.shape, dtype=plane.dtype, device=plane.device)
    for j in range(plane.shape[0]):
        acc = acc + c[:, j:j + 1] * plane[j:j + 1]
    return acc


def gossip_plane(plane: torch.Tensor, coeffs: torch.Tensor,
                 mix_in_float32: bool = True) -> torch.Tensor:
    """``out = coeffs @ plane``: plane ``(n, P)`` f32 or bf16, coeffs
    ``(n, n)`` f32; f32 accumulation unless ``mix_in_float32=False``.  A
    plane ``(E, n, P)`` with coeffs ``(E, n, n)`` mixes E experiments in
    one launch."""
    _check_plane(plane)
    *lead, n, p = plane.shape
    if tuple(coeffs.shape) != tuple(lead) + (n, n):
        raise ValueError(f"coeffs must be {tuple(lead) + (n, n)}, got "
                         f"{tuple(coeffs.shape)}")
    if plane.device.type == "cpu":
        return gossip_plane_ref(plane, coeffs, mix_in_float32)
    if plane.device.type != "cuda":
        raise ValueError(f"gossip_plane runs on cuda or cpu, got "
                         f"{plane.device}")
    if coeffs.device != plane.device or coeffs.dtype != torch.float32:
        raise ValueError("coeffs must be float32 on the plane's device")
    coeffs = coeffs.contiguous()
    experiments = lead[0] if lead else 1
    ld = _check_cuda_plane(_rows_view(plane, "gossip_plane"), "gossip_plane")
    out = _out_like(plane, ld)
    lowp = int(not mix_in_float32 and plane.dtype != torch.float32)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = _lib().gossip_plane_launch(
            coeffs.data_ptr(), plane.data_ptr(), out.data_ptr(), n, p, ld,
            experiments, _DTYPE_CODES[plane.dtype], lowp, stream,
            _plan_args(n, n, p, plane, experiments))
    _raise_on(rc, "gossip_plane")
    gossip_plane.launches += 1
    gossip_plane.shapes[_shape_key(plane)] += 1
    return out


gossip_plane.launches = 0
gossip_plane.shapes = collections.Counter()


def _fold(params, coeffs: torch.Tensor):
    """A tree of ``(E, n, ...)`` leaves as ``(E·n, ...)`` (the tree itself
    for ``(n, n)`` coefficients)."""
    if coeffs.ndim == 2:
        return params
    return tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]),
                              params)


def _pack(params, coeffs: torch.Tensor):
    """``(layout, plane)``: the folded tree packed once, the plane seen as
    ``(E, n, P)`` for ``(E, n, n)`` coefficients."""
    flat = _fold(params, coeffs)
    layout = PlaneLayout.from_tree(flat)
    plane = layout.pack(flat)
    if coeffs.ndim == 3:
        plane = plane.unflatten(0, (coeffs.shape[0], -1))
    return layout, plane


def _unpack(layout: PlaneLayout, mixed: torch.Tensor, coeffs: torch.Tensor):
    if coeffs.ndim == 2:
        return layout.unpack(mixed)
    e = coeffs.shape[0]
    return tree_util.tree_map(lambda x: x.reshape((e, -1) + x.shape[1:]),
                              layout.unpack(mixed.flatten(0, 1)))


def mix_plane(params, coeffs: torch.Tensor, mix_in_float32: bool = True):
    """Eq. (2) over a stacked tree via :func:`gossip_plane`: pack once (in
    the widest leaf dtype) → one launch → unpack once, whatever the leaf
    count; ``(E, n, ...)`` trees with ``(E, n, n)`` coefficients are one
    pack and one launch for all E."""
    layout, plane = _pack(params, coeffs)
    mixed = gossip_plane(plane, coeffs.to(torch.float32), mix_in_float32)
    return _unpack(layout, mixed, coeffs)


# ----------------------------------------------------------------------
# edge-list mix
# ----------------------------------------------------------------------
def gossip_edges_ref(plane: torch.Tensor, weights: torch.Tensor,
                     nbr_idx: torch.Tensor,
                     mix_in_float32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`gossip_edges`: the gather-mul-sum
    of ``mix_edges`` in ascending d from 0, each product and sum its own
    rounded op (in bf16, weight included, when ``mix_in_float32=False``
    on a bf16 plane).  ``(E, n, P)`` with ``(E, n, dmax)`` weights: each
    experiment's own call."""
    if plane.ndim == 3:
        return torch.stack([gossip_edges_ref(plane[e], weights[e], nbr_idx,
                                             mix_in_float32)
                            for e in range(plane.shape[0])])
    lowp = not mix_in_float32 and plane.dtype != torch.float32
    acc_dtype = plane.dtype if lowp else torch.float32
    w = weights.to(acc_dtype)
    idx = nbr_idx.long()
    acc = torch.zeros(plane.shape, dtype=acc_dtype, device=plane.device)
    for d in range(idx.shape[1]):
        acc = acc + w[:, d:d + 1] * plane[idx[:, d]].to(acc_dtype)
    return acc.to(plane.dtype)


def _check_tables(plane: torch.Tensor, weights: torch.Tensor,
                  nbr_idx: torch.Tensor) -> None:
    """weights ``(n, dmax)`` (``(E, n, dmax)`` for an ``(E, n, P)`` plane)
    and one ``(n, dmax)`` table."""
    *lead, n, _ = plane.shape
    if weights.ndim != plane.ndim or tuple(weights.shape[:-1]) != \
            tuple(lead) + (n,) or nbr_idx.ndim != 2 or \
            tuple(nbr_idx.shape) != tuple(weights.shape[-2:]):
        raise ValueError(
            f"weights must be {tuple(lead) + (n,)} + (dmax,) and nbr_idx "
            f"({n}, dmax), got {tuple(weights.shape)} and "
            f"{tuple(nbr_idx.shape)}")


def _check_cuda_tables(plane: torch.Tensor, weights: torch.Tensor,
                       nbr_idx: torch.Tensor, name: str) -> None:
    if plane.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {plane.device}")
    if weights.device != plane.device or weights.dtype != torch.float32:
        raise ValueError("weights must be float32 on the plane's device")
    if nbr_idx.device != plane.device or nbr_idx.dtype != torch.int32:
        raise ValueError("nbr_idx must be int32 on the plane's device")


def gossip_edges(plane: torch.Tensor, weights: torch.Tensor,
                 nbr_idx: torch.Tensor,
                 mix_in_float32: bool = True) -> torch.Tensor:
    """``out[i] = Σ_d weights[i, d] · plane[nbr_idx[i, d]]``: plane
    ``(n, P)`` f32 or bf16, weights ``(n, dmax)`` f32 (zero on padding
    slots), nbr_idx ``(n, dmax)`` int32 rows in ``[0, n)`` (padding = own
    row).  A CUDA launch with an index outside ``[0, n)`` traps.  A plane
    ``(E, n, P)`` with weights ``(E, n, dmax)`` mixes E experiments in one
    launch over the one shared table."""
    _check_plane(plane)
    *lead, n, p = plane.shape
    _check_tables(plane, weights, nbr_idx)
    if plane.device.type == "cpu":
        return gossip_edges_ref(plane, weights, nbr_idx, mix_in_float32)
    _check_cuda_tables(plane, weights, nbr_idx, "gossip_edges")
    weights, nbr_idx = weights.contiguous(), nbr_idx.contiguous()
    ld = _check_cuda_plane(_rows_view(plane, "gossip_edges"), "gossip_edges")
    out = _out_like(plane, ld)
    lowp = int(not mix_in_float32 and plane.dtype != torch.float32)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = _lib().gossip_edges_launch(
            weights.data_ptr(), nbr_idx.data_ptr(), plane.data_ptr(),
            out.data_ptr(), n, weights.shape[-1], p, ld,
            lead[0] if lead else 1, _DTYPE_CODES[plane.dtype], lowp, stream)
    _raise_on(rc, "gossip_edges")
    gossip_edges.launches += 1
    gossip_edges.shapes[_shape_key(plane)] += 1
    return out


gossip_edges.launches = 0
gossip_edges.shapes = collections.Counter()


def mix_edges_kernel(params, coeffs: torch.Tensor, nbr_idx: torch.Tensor,
                     nbr_mask: torch.Tensor, mix_in_float32: bool = True):
    """Eq. (2) over a stacked tree via :func:`gossip_edges`: pack once →
    per-edge weight gather (``core.mixing.edge_weights``, in torch as the
    reference does it outside Pallas) → one launch → unpack once (for
    ``(E, n, n)`` coefficients, once for the whole grid)."""
    layout, plane = _pack(params, coeffs)
    w = edge_weights(coeffs.to(torch.float32), nbr_idx, nbr_mask)
    mixed = gossip_edges(plane, w, nbr_idx.to(torch.int32), mix_in_float32)
    return _unpack(layout, mixed, coeffs)


# ----------------------------------------------------------------------
# robust edge-list mix
# ----------------------------------------------------------------------
ROBUST_OPS = ("trimmed", "median")
# csrc/gossip_robust.cu's constants: warps a block, the slot counts of
# its instantiations, the tile widths a block may own
ROBUST_WARPS = 8
ROBUST_SLOTS = (8, 16, 32, 64)
ROBUST_TILES = (256, 128, 64, 32)


def robust_cols(slots: int, op: str) -> int:
    """Columns a lane takes in a unit of ``robust_kernel`` (csrc
    ``cols_for``): two for the median over tables of at most 16 slots,
    else one."""
    return 2 if op == "median" and slots <= 16 else 1


@dataclass(frozen=True)
class RobustPlan:
    """How ``robust_kernel`` runs: block ``b`` owns plane columns ``b ·
    tile_cols`` on (``tile_cols`` of them) for every destination row,
    ``grid`` blocks in all; its warps take runs of (row, ``32 ·
    robust_cols(slots, op)`` columns) units.  ``staged``: the tile's n plane rows sit in
    shared memory, else the neighbours are gathered from global memory.
    ``slots``: the instantiation's table width (the table's dmax rounded
    up to 8, 16, 32 or 64), whose compile-time buckets 4, 8, … ``slots``
    size the sort.  ``smem_bytes``: the tile (when staged) and each
    warp's compacted table."""

    tile_cols: int
    staged: bool
    slots: int
    grid: int
    smem_bytes: int
    blocks_per_sm: int

    def c_args(self):
        """The plan as the C entry takes it (``RobustPlan``'s order)."""
        return (ctypes.c_longlong * 5)(self.tile_cols, int(self.staged),
                                       self.slots, self.grid,
                                       self.smem_bytes)


def robust_plan(n: int, p: int, dmax: int, dtype: torch.dtype,
                op: str = "trimmed") -> RobustPlan:
    """The launch plan of ``robust_kernel`` for an ``(n, p)`` plane of
    ``dtype``, tables ``dmax`` slots wide and the rule ``op``.

    The widest tile of 256, 128, 64 or 32 columns (a multiple of a unit's
    ``32 · robust_cols(slots, op)``) whose n rows let two blocks share an
    SM's shared memory (with each warp's 8-byte-a-slot table beside
    them); where none fits (n above some 880 rows in f32, 1,760 in bf16,
    half that for a two-column median), 256 columns a block gathered from
    global memory.  The VGG-16 and FFN planes (n = 33): 256 columns, staged,
    33.8 KB a tile in f32."""
    if n < 1 or p < 0 or dmax < 0:
        raise ValueError(f"robust_plan needs n >= 1, P >= 0, dmax >= 0, "
                         f"got {n}, {p}, {dmax}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"robust_plan takes float32 or bfloat16, got {dtype}")
    slots = next((s for s in ROBUST_SLOTS if dmax <= s), None)
    if slots is None:
        raise ValueError(
            f"gossip_robust: table width dmax={dmax} is wider than the "
            f"widest kernel instantiation ({ROBUST_SLOTS[-1]} slots); a node "
            f"with that many neighbours needs a wider instantiation in "
            f"csrc/gossip_robust.cu")
    itemsize = 4 if dtype == torch.float32 else 2
    table = ROBUST_WARPS * slots * 8
    for tile in ROBUST_TILES:
        if tile % (32 * robust_cols(slots, op)):
            continue
        smem = n * tile * itemsize + table
        if 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM:
            staged = True
            break
    else:
        tile, smem, staged = ROBUST_TILES[0], table, False
    bps = min(BLOCKS_PER_SM, THREADS_PER_SM // (32 * ROBUST_WARPS),
              SMEM_PER_SM // (smem + SMEM_RESERVED))
    return RobustPlan(tile, staged, slots, _cdiv(p, tile), smem, bps)


def gossip_robust_ref(plane: torch.Tensor, weights: torch.Tensor,
                      nbr_idx: torch.Tensor, op: str = "trimmed",
                      trim_k: int = 1,
                      mix_in_float32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`gossip_robust`: gather the
    ``(dmax, n, P)`` neighbour values and reduce them with
    ``core.mixing.robust_combine`` (the reference's stable odd-even sort,
    sums in ascending sorted order, in bf16 when ``mix_in_float32=False``
    on a bf16 plane).  Memory is ``2·dmax·n·P`` accumulation-dtype
    values: columns are independent, so a caller may run it over column
    chunks.  ``(E, n, P)`` with ``(E, n, dmax)`` weights: each
    experiment's own call."""
    if plane.ndim == 3:
        return torch.stack([gossip_robust_ref(plane[e], weights[e], nbr_idx,
                                              op, trim_k, mix_in_float32)
                            for e in range(plane.shape[0])])
    lowp = not mix_in_float32 and plane.dtype != torch.float32
    acc_dtype = plane.dtype if lowp else torch.float32
    flat = plane.to(acc_dtype)
    out = robust_combine(flat[nbr_idx.long().T], weights.T.to(acc_dtype),
                         flat, op, trim_k=trim_k)
    return out.to(plane.dtype)


def gossip_robust(plane: torch.Tensor, weights: torch.Tensor,
                  nbr_idx: torch.Tensor, op: str = "trimmed",
                  trim_k: int = 1,
                  mix_in_float32: bool = True) -> torch.Tensor:
    """Robust Eq. (2) over padded-ELL tables: for each destination row
    and column, the trimmed mean (``trim_k`` per side) or the median of
    the occupied slots' values (slots with weight > 0), falling back to
    the row's own value.  Operands as :func:`gossip_edges`; on the card
    the table width dmax is at most the widest kernel instantiation (64)
    and an index outside ``[0, n)`` traps.  ``(E, n, P)`` with ``(E, n,
    dmax)`` weights: E experiments in one launch, each block staging only
    its own experiment's rows (the plan is the single experiment's)."""
    _check_plane(plane)
    *lead, n, p = plane.shape
    _check_tables(plane, weights, nbr_idx)
    if op not in ROBUST_OPS:
        raise ValueError(f"gossip_robust op {op!r} not in {ROBUST_OPS}")
    if trim_k < 0:
        raise ValueError(f"trim_k must be >= 0, got {trim_k}")
    if plane.device.type == "cpu":
        return gossip_robust_ref(plane, weights, nbr_idx, op, trim_k,
                                 mix_in_float32)
    _check_cuda_tables(plane, weights, nbr_idx, "gossip_robust")
    dmax = weights.shape[-1]
    plan = robust_plan(n, p, dmax, plane.dtype, op)
    lib = _lib("gossip_robust")
    weights, nbr_idx = weights.contiguous(), nbr_idx.contiguous()
    ld = _check_cuda_plane(_rows_view(plane, "gossip_robust"),
                           "gossip_robust")
    out = _out_like(plane, ld)
    lowp = int(not mix_in_float32 and plane.dtype != torch.float32)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = lib.gossip_robust_launch(
            weights.data_ptr(), nbr_idx.data_ptr(), plane.data_ptr(),
            out.data_ptr(), n, dmax, p, ld, lead[0] if lead else 1,
            _DTYPE_CODES[plane.dtype], lowp, int(op == "median"), trim_k,
            plan.c_args(), stream)
    _raise_on(rc, "gossip_robust")
    gossip_robust.launches += 1
    gossip_robust.shapes[_shape_key(plane, op)] += 1
    return out


gossip_robust.launches = 0
gossip_robust.shapes = collections.Counter()


def mix_robust_kernel(params, coeffs: torch.Tensor, nbr_idx: torch.Tensor,
                      nbr_mask: torch.Tensor, op: str = "trimmed",
                      trim_k: int = 1, mix_in_float32: bool = True):
    """Robust Eq. (2) over a stacked tree via :func:`gossip_robust`: pack
    once → per-edge weight gather → one launch → unpack once.  Equals
    ``core.mixing.mix_robust_tables`` bit for bit on the CPU; ``(E, n,
    ...)`` trees with ``(E, n, n)`` coefficients are one launch."""
    layout, plane = _pack(params, coeffs)
    w = edge_weights(coeffs.to(torch.float32), nbr_idx, nbr_mask)
    mixed = gossip_robust(plane, w, nbr_idx.to(torch.int32), op, trim_k,
                          mix_in_float32)
    return _unpack(layout, mixed, coeffs)


# ----------------------------------------------------------------------
# legacy per-row K-way MAC (the mix-cost study's baseline)
# ----------------------------------------------------------------------
def _weight_rows(blocks: torch.Tensor, weights: torch.Tensor):
    """``(R, K)`` view of ``weights`` ``(K,)`` or ``(R, K)``, checked
    against ``blocks`` ``(K, M, N)``."""
    if blocks.ndim != 3:
        raise ValueError(f"blocks must be (K, M, N), got "
                         f"{tuple(blocks.shape)}")
    k = blocks.shape[0]
    if weights.ndim not in (1, 2) or weights.shape[-1] != k:
        raise ValueError(f"weights must be ({k},) or (R, {k}), got "
                         f"{tuple(weights.shape)}")
    return weights.reshape(-1, k)


def gossip_mix_ref(blocks: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gossip_mix`: f32 sums in ascending
    k from 0, each product and each sum its own rounded f32 op, cast to
    the blocks' dtype once."""
    w = _weight_rows(blocks, weights).float()
    acc = torch.zeros((w.shape[0],) + tuple(blocks.shape[1:]),
                      dtype=torch.float32, device=blocks.device)
    for k in range(blocks.shape[0]):
        acc = acc + w[:, k, None, None] * blocks[k].float()
    out = acc.to(blocks.dtype)
    return out[0] if weights.ndim == 1 else out


def gossip_mix(blocks: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out = Σ_k weights[k] · blocks[k]``: blocks ``(K, M, N)`` f32 or
    bf16, weights ``(K,)`` f32 → ``(M, N)``, or ``(R, K)`` → ``(R, M, N)``
    (one launch for all R rows).  Any N at any alignment: the kernel
    takes a scalar path where its 16-byte loads do not apply.  On the
    card the last dimension must be contiguous."""
    w = _weight_rows(blocks, weights)
    if blocks.device.type == "cpu":
        return gossip_mix_ref(blocks, weights)
    if blocks.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cuda or cpu, got "
                         f"{blocks.device}")
    if blocks.dtype not in _DTYPE_CODES:
        raise TypeError(f"blocks dtype must be float32 or bfloat16, got "
                        f"{blocks.dtype}")
    if w.device != blocks.device or w.dtype != torch.float32:
        raise ValueError("weights must be float32 on the blocks' device")
    k, m, n = blocks.shape
    if blocks.stride(2) != 1 and n > 1:
        raise ValueError("gossip_mix: the blocks' last dimension must be "
                         "contiguous")
    w = w.contiguous()
    r = w.shape[0]
    out = torch.empty((r, m, n), dtype=blocks.dtype, device=blocks.device)
    if out.numel() and k:
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream(blocks.device).cuda_stream
            rc = _lib().gossip_mix_launch(
                w.data_ptr(), blocks.data_ptr(), out.data_ptr(), r, k, m, n,
                blocks.stride(0), blocks.stride(1),
                _DTYPE_CODES[blocks.dtype], stream,
                _plan_args(r, k, m * n, blocks))
        _raise_on(rc, "gossip_mix")
        gossip_mix.launches += 1
        gossip_mix.shapes[(r, k, m, n, str(blocks.dtype)[6:])] += 1
    elif out.numel():
        out.zero_()
    return out[0] if weights.ndim == 1 else out


gossip_mix.launches = 0
gossip_mix.shapes = collections.Counter()


def mix_dense_rows(params, coeffs: torch.Tensor):
    """Eq. (2) leaf by leaf through :func:`gossip_mix` — the counterpart
    of the reference's legacy ``mix_dense_pallas``: each leaf ``(n,
    ...)`` is ``K = n`` blocks ``(1, numel / n)`` mixed into all n
    destination rows in one launch (the reference's ``jax.vmap`` over the
    rows of C, one ``pallas_call`` a leaf); the result takes the leaf's
    shape and dtype."""
    c = coeffs.to(torch.float32)
    n = c.shape[0]

    def leaf_fn(leaf):
        out = gossip_mix(leaf.reshape(n, 1, -1), c)
        return out.reshape(leaf.shape).to(leaf.dtype)

    return tree_util.tree_map(leaf_fn, params)


def mix_modeled_hbm_bytes(impl: str, n: int, p_floats: int,
                          itemsize: int = 4, n_leaves: int = 1,
                          bt: int = 2048, max_neighbors: Optional[int] = None,
                          n_offsets: Optional[int] = None) -> int:
    """Modeled device-memory bytes of one mix of an n-node model with
    ``p_floats`` parameters a node (``itemsize`` bytes each, over
    ``n_leaves`` leaves): the reference's model, integer for integer.

    * ``"einsum"``: one product per leaf, ``2·n·P·b + n_leaves·n²·4``;
    * ``"pallas_rows"``: the legacy fan-out, every destination row of
      every leaf re-reading its slab, ``n·(n+1)·P·b + n_leaves·n²·4``;
    * ``"pallas_plane"``: the fused plane, ``2·n·P·b + ⌈P/bt⌉·n²·4``, and
      ``"pallas_plane_e2e"`` with the pack and unpack copies,
      ``6·n·P·b + ⌈P/bt⌉·n²·4``;
    * ``"edges"`` / ``"edges_robust"`` (need ``max_neighbors``, the table
      width dmax): ``2·n·P·b + ⌈P/bt⌉·n·dmax·8``;
    * ``"sparse"`` (needs ``n_offsets``, the circulant schedule's offset
      count with 0): ``(K+1)·n·P·b + K·n·4``.
    """
    coeff = n * n * 4
    if impl == "einsum":
        return 2 * n * p_floats * itemsize + n_leaves * coeff
    if impl == "pallas_rows":
        return n * (n + 1) * p_floats * itemsize + n_leaves * n * n * 4
    if impl == "sparse":
        if n_offsets is None:
            raise ValueError("impl='sparse' needs n_offsets (the circulant "
                             "schedule's static offset count, incl. 0)")
        return ((n_offsets + 1) * n * p_floats * itemsize
                + n_offsets * n * 4)
    tiles = -(-p_floats // bt)
    if impl in ("edges", "edges_robust"):
        if max_neighbors is None:
            raise ValueError(f"impl={impl!r} needs max_neighbors (the "
                             "padded-ELL table width dmax)")
        return (2 * n * p_floats * itemsize
                + tiles * n * max_neighbors * 8)
    if impl == "pallas_plane":
        return 2 * n * p_floats * itemsize + tiles * coeff
    if impl == "pallas_plane_e2e":
        return 6 * n * p_floats * itemsize + tiles * coeff
    raise KeyError(f"unknown impl {impl!r}")
