"""The port's CUDA kernels against their plain PyTorch versions on the
card (``cuda`` marker: they skip without a GPU, where the kernels cannot
build).  This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import topology as ttopo
from repro_torch.core.decentralized import edges_schedule
from repro_torch.core.mixing import edge_weights
from repro_torch.core.plane import aligned_plane
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gossip_mix as tk
from repro_torch.kernels import mla_attention as tmla
from repro_torch.kernels import ssm_scan as tscan

torch.set_num_threads(2)


def _inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    plane = rng.normal(size=(n, p)).astype(np.float32)
    topo = ttopo.barabasi_albert(n, 2, seed)
    idx, msk = topo.neighbor_tables()
    c = rng.random((n, n)).astype(np.float32)
    c = c * (topo.adjacency + np.eye(n)).astype(np.float32)
    return plane, (c / c.sum(1, keepdims=True)).astype(np.float32), idx, msk


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("f32", [True, False])
def test_kernels_match_plain_versions_on_the_card(dtype, aligned, f32):
    """Each CUDA kernel against its plain version on the same inputs on
    the card: f32 within 1e-5·max|ref| (another summation order), bf16
    within one bf16 ulp, the bf16-accumulation ablation and every edges
    case bit for bit (same arithmetic, op for op).  A plane whose rows are
    not 16-byte aligned is refused before any launch.  The plane sizes
    take every shape of the streaming kernel's plan: P under one tile,
    P off the vector width, two row blocks and two source chunks (n = 65,
    70), one full row block (64), sixteen with 22 chunks and the
    coefficients staged a slice a stage (1024), and more column tiles
    than resident blocks, so the persistent walk wraps (33, 200,003)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for n, p in ((5, 37), (33, 1001), (70, 515), (64, 515), (65, 1001),
                 (1024, 301), (33, 200_003)):
        plane, c, idx, msk = _inputs(n, p, n)
        ct = torch.as_tensor(c).cuda()
        it, mt = torch.as_tensor(idx).cuda(), torch.as_tensor(msk).cuda()
        w = edge_weights(ct, it, mt)
        launches = tk.gossip_plane.launches, tk.gossip_edges.launches
        if not aligned:   # odd P: a contiguous plane's rows are unaligned
            pt = torch.as_tensor(plane).to(dtype).cuda()
            with pytest.raises(ValueError, match="16-byte"):
                tk.gossip_plane(pt, ct, f32)
            with pytest.raises(ValueError, match="16-byte"):
                tk.gossip_edges(pt, w, it, f32)
            assert (tk.gossip_plane.launches,
                    tk.gossip_edges.launches) == launches
            continue
        pt = aligned_plane(n, p, dtype, "cuda")
        pt.copy_(torch.as_tensor(plane))
        got_p = tk.gossip_plane(pt, ct, f32).float()
        got_e = tk.gossip_edges(pt, w, it, f32).float()
        torch.cuda.synchronize()
        assert (tk.gossip_plane.launches, tk.gossip_edges.launches) == (
            launches[0] + 1, launches[1] + 1)
        ref_p = tk.gossip_plane_ref(pt, ct, f32).float()
        ref_e = tk.gossip_edges_ref(pt, w, it, f32).float()
        assert torch.equal(got_e, ref_e)
        if dtype == torch.float32:
            assert (got_p - ref_p).abs().max() <= 1e-5 * ref_p.abs().max()
        elif f32:
            assert bool(((got_p - ref_p).abs() <= _bf16_ulp(ref_p)).all())
        else:
            assert torch.equal(got_p, ref_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_kernel_stays_inside_a_one_row_plane_on_the_card(dtype):
    """A contiguous (1, 37) plane passes the wrappers' checks (one row, a
    16-byte aligned base) though its row holds 37 values, not a 16-byte
    multiple.  Its last vector is copied with the bytes left in the row
    and zero-filled past them (``tests/test_torch_gossip_plan.py`` pins
    the highest column read at P - 1), so in a buffer whose next values
    are NaN the mix is finite, within its gate of the plain version, and
    the buffer past the row is unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    buf = torch.full((64,), float("nan"), dtype=dtype, device="cuda")
    plane = buf[:37].view(1, 37)
    plane.copy_(torch.as_tensor(np.random.default_rng(0).normal(
        size=(1, 37)).astype(np.float32)))
    c = torch.full((1, 1), 0.75, device="cuda")
    before = tk.gossip_plane.launches
    got = tk.gossip_plane(plane, c).float()
    torch.cuda.synchronize()
    assert tk.gossip_plane.launches == before + 1
    ref = tk.gossip_plane_ref(plane, c).float()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        assert bool(((got - ref).abs() <= _bf16_ulp(ref)).all())
    assert bool(buf[37:].isnan().all())


def _robust_case(n, p, seed, star=False):
    """(plane, w, idx) on BA(n, 2) or, with ``star``, a hub joined to every
    other node (table width n): random weights, a few zeroed, rows 0, 3
    and 5 poisoned with NaN / +Inf / -Inf."""
    rng = np.random.default_rng(seed)
    if star:
        sup = np.eye(n)
        sup[0, :] = sup[:, 0] = 1.0
    else:
        sup = ttopo.barabasi_albert(n, 2, seed).adjacency + np.eye(n)
    idx, msk = edges_schedule(sup)
    c = rng.random((n, n)) * sup * (rng.random((n, n)) > 0.1)
    np.fill_diagonal(c, np.diagonal(c) + 0.5)
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    plane = rng.normal(size=(n, p)).astype(np.float32)
    plane[0] = np.nan
    plane[2, ::2] = np.inf
    plane[n - 1] = -np.inf
    w = edge_weights(torch.as_tensor(c), torch.as_tensor(idx),
                     torch.as_tensor(msk))
    return plane, w, torch.as_tensor(idx, dtype=torch.int32)


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("trimmed", 2),
                                       ("median", 0)])
def test_robust_kernel_equals_plain_version_on_the_card(dtype, f32, op,
                                                        trim_k):
    """``gossip_robust`` against ``gossip_robust_ref`` on the same inputs
    on the card, bit for bit (the same sort order, sums in the same order,
    no FMA), with NaN/±Inf rows, across table widths that select each
    instantiation: 5, 15, 20 and 64 slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cases = [(5, 37, 1, False), (33, 1001, 2, False), (70, 515, 3, False),
             (64, 300, 4, True)]
    for n, p, seed, star in cases:
        plane, w, idx = _robust_case(n, p, seed, star)
        pt = aligned_plane(n, p, dtype, "cuda")
        pt.copy_(torch.as_tensor(plane))
        w, idx = w.cuda(), idx.cuda()
        before = tk.gossip_robust.launches
        got = tk.gossip_robust(pt, w, idx, op, trim_k, f32)
        torch.cuda.synchronize()
        assert tk.gossip_robust.launches == before + 1
        ref = tk.gossip_robust_ref(pt, w, idx, op, trim_k, f32)
        assert got.dtype == dtype and got.shape == (n, p)
        assert _same(got.float(), ref.float()), (n, p)


@pytest.mark.cuda
def test_robust_kernel_refuses_what_it_cannot_take():
    """A plane with unaligned rows, and a table wider than the widest
    instantiation (64 slots), are refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plane, w, idx = _robust_case(33, 1001, 2)
    before = tk.gossip_robust.launches
    with pytest.raises(ValueError, match="16-byte"):
        tk.gossip_robust(torch.as_tensor(plane).cuda(), w.cuda(), idx.cuda())
    plane, w, idx = _robust_case(65, 64, 5, star=True)
    assert w.shape[1] == 65
    pt = aligned_plane(65, 64, torch.float32, "cuda")
    pt.copy_(torch.as_tensor(plane))
    with pytest.raises(ValueError, match="widest kernel instantiation"):
        tk.gossip_robust(pt, w.cuda(), idx.cuda())
    assert tk.gossip_robust.launches == before


def _counts_case(counts, dmax, n, p, seed):
    """(plane, w, idx): row i with ``counts[i % len(counts)]`` occupied
    slots scattered over ``dmax`` slots whose indices repeat source rows
    (ties with other weights); rows 1, 2, 3 NaN, +Inf, -Inf in part."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, dmax)).astype(np.int32)
    w = np.zeros((n, dmax), np.float32)
    for i in range(n):
        cnt = counts[i % len(counts)]
        w[i, rng.choice(dmax, size=cnt, replace=False)] = (
            rng.random(cnt).astype(np.float32) + 0.05)
    plane = rng.standard_normal((n, p)).astype(np.float32)
    plane[1] = np.nan
    plane[2, ::2] = np.inf
    plane[3, 1::3] = -np.inf
    return plane, torch.as_tensor(w), torch.as_tensor(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f32", [(torch.float32, True),
                                       (torch.bfloat16, True),
                                       (torch.bfloat16, False)])
@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("trimmed", 2),
                                       ("median", 0)])
@pytest.mark.parametrize("n,p,dmax", [
    (40, 1003, 64),   # every count bucket's edges; P not a tile or vector
    (12, 37, 16),     # buckets up to 16, one ragged tile
    (1000, 515, 8),   # 32 columns of 1000 f32 rows do not fit: gathers
])
def test_robust_kernel_at_count_buckets_on_the_card(dtype, f32, op, trim_k,
                                                    n, p, dmax):
    """Rows with 0, 1, 4, 5, 8, 9, 16, 17 and 64 occupied slots (as far as
    the table width allows) on planes with NaN/±Inf rows, a P that is no
    multiple of the tile or of the 16-byte vector, and an n whose tile
    does not fit shared memory in f32 (the kernel gathers from global
    memory there): bit for bit the plain version, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    counts = [c for c in (0, 1, 4, 5, 8, 9, 16, 17, 64) if c <= dmax]
    plane, w, idx = _counts_case(counts, dmax, n, p, n + p)
    pt = aligned_plane(n, p, dtype, "cuda")
    pt.copy_(torch.as_tensor(plane))
    plan = tk.robust_plan(n, p, dmax, dtype, op)
    if n == 1000 and dtype == torch.float32:
        assert not plan.staged
    w, idx = w.cuda(), idx.cuda()
    before = tk.gossip_robust.launches
    got = tk.gossip_robust(pt, w, idx, op, trim_k, f32)
    torch.cuda.synchronize()
    assert tk.gossip_robust.launches == before + 1
    ref = tk.gossip_robust_ref(pt, w, idx, op, trim_k, f32)
    assert got.dtype == dtype and _same(got.float(), ref.float())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tk.ROBUST_TILES)
def test_robust_kernel_under_every_tile_width_on_the_card(tile):
    """The C entry under each tile width the plan may choose (a staged
    tile of 33 rows), the trimmed mean: bit for bit the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plane, w, idx = _robust_case(33, 1001, 2)
    pt = aligned_plane(33, 1001, torch.float32, "cuda")
    pt.copy_(torch.as_tensor(plane))
    w, idx = w.cuda(), idx.cuda()
    best = tk.robust_plan(33, 1001, idx.shape[1], torch.float32)
    assert tk.robust_cols(best.slots, "trimmed") == 1
    plan = tk.RobustPlan(tile, True, best.slots, -(-1001 // tile),
                         33 * tile * 4 + tk.ROBUST_WARPS * best.slots * 8, 0)
    out = tk._out_like(pt, pt.stride(0))
    rc = tk._lib("gossip_robust").gossip_robust_launch(
        w.data_ptr(), idx.data_ptr(), pt.data_ptr(), out.data_ptr(), 33,
        idx.shape[1], 1001, pt.stride(0), 0, 0, 0, 1, plan.c_args(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert _same(out, tk.gossip_robust_ref(pt, w, idx, "trimmed", 1))


@pytest.mark.cuda
def test_robust_kernel_refuses_a_plan_for_other_operands_on_the_card():
    """A plan whose grid leaves columns out, whose slots are narrower than
    the table, whose shared bytes are not the layout's, or whose tile the
    median's unit of two 32-column halves does not divide, is refused
    before any launch (cudaErrorInvalidValue)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plane, w, idx = _robust_case(33, 1001, 2)
    pt = aligned_plane(33, 1001, torch.float32, "cuda")
    pt.copy_(torch.as_tensor(plane))
    w, idx = w.cuda(), idx.cuda()
    good = tk.robust_plan(33, 1001, idx.shape[1], torch.float32)
    out = tk._out_like(pt, pt.stride(0))
    fields = ("tile_cols", "staged", "slots", "grid", "smem_bytes",
              "blocks_per_sm")
    narrow = {"tile_cols": 32, "grid": -(-1001 // 32),
              "smem_bytes": 33 * 32 * 4 + tk.ROBUST_WARPS * good.slots * 8}
    assert tk.robust_cols(good.slots, "median") == 2
    for change, median in (({"grid": good.grid - 1}, 0), ({"slots": 8}, 0),
                           ({"smem_bytes": good.smem_bytes + 16}, 0),
                           (narrow, 1)):
        bad = tk.RobustPlan(**{f: change.get(f, getattr(good, f))
                               for f in fields})
        rc = tk._lib("gossip_robust").gossip_robust_launch(
            w.data_ptr(), idx.data_ptr(), pt.data_ptr(), out.data_ptr(), 33,
            idx.shape[1], 1001, pt.stride(0), 0, 0, median, 1 - median,
            bad.c_args(), torch.cuda.current_stream().cuda_stream)
        assert rc != 0, change


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
def _qkv_case(b, s, h, kv, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=shape).astype(np.float32))
                 .to(dtype).cuda()
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window,cap", [
    (1, 128, 4, 2, 32, 0, 0.0),      # GQA, one full tile pair
    (2, 100, 4, 4, 32, 16, 20.0),    # ragged S, window and softcap
    (1, 1000, 8, 2, 64, 256, 50.0),  # ragged, many tiles, window > tile
    (2, 300, 4, 1, 64, 0, 0.0),      # MQA, ragged
    (1, 520, 4, 2, 128, 200, 50.0),  # hd 128 (32-key tiles), gemma2 cap
    (3, 64, 2, 2, 128, 0, 0.0),      # one q tile exactly
    (1, 7, 3, 1, 32, 3, 0.0),        # shorter than a tile
    # the bf16 kernel's 64-row tile edges: S, hd, window and g around them
    (1, 1, 4, 4, 64, 0, 0.0),        # one position
    (2, 15, 4, 2, 32, 1, 0.0),       # window 1: each row sees itself
    (1, 63, 8, 2, 128, 63, 50.0),    # one short of a tile, g = 4
    (1, 65, 4, 1, 64, 64, 0.0),      # one past a tile, window = tile
    (2, 129, 4, 2, 128, 200, 50.0),  # two tiles and one row, window > S
    (1, 129, 2, 2, 32, 64, 20.0),    # hd 32, window = tile, g = 1
    (1, 65, 4, 4, 128, 1, 0.0),      # window 1 across a tile edge
])
def test_flash_kernel_matches_plain_version_on_the_card(dtype, b, s, h, kv,
                                                        hd, window, cap):
    """The flash kernel against ``flash_attention_ref`` on the same card
    inputs: f32 within 2e-5·max|ref| (another summation order: the
    online softmax against one softmax); bf16 within one bf16 ulp of the
    plain version's output beyond that same f32 bound (each rounds its own
    f32 value once, and near zero the f32 difference exceeds an ulp);
    all finite, exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    q, k, v = _qkv_case(b, s, h, kv, hd, s + hd, dtype)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, window=window, logit_softcap=cap)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_ref(q, k, v, window=window,
                                  logit_softcap=cap)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    got, ref = got.float(), ref.float()
    f32_tol = 2e-5 * ref.abs().max()
    if dtype == torch.float32:
        assert (got - ref).abs().max() <= f32_tol
    else:
        assert bool(((got - ref).abs() <= _bf16_ulp(ref) + f32_tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_inputs_on_the_card(dtype):
    """q, k, v read in place through their strides (slices of one fused
    qkv tensor, as a model might hand them over; in bf16 their rows stay
    16-byte aligned, as the tensor-core kernel's copies need), within the
    gates of ``test_flash_kernel_matches_plain_version_on_the_card``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.normal(size=(2, 200, 8, 64)).astype(
        np.float32)).to(dtype).cuda()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, window=50).float()
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=50).float()
    tol = 2e-5 * ref.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(ref)
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_flash_bf16_kernel_refuses_unaligned_rows():
    """The bf16 kernel copies rows 16 bytes at a time: a head stride that
    is not a multiple of 8 elements, or a base 8 bytes off, is refused
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    q, k, v = _qkv_case(1, 64, 4, 2, 72, 0, torch.bfloat16)
    k, v = k[..., :64].contiguous(), v[..., :64].contiguous()
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q[..., 4:68], k, v)     # base 8 bytes off
    q68 = torch.zeros((1, 64, 4, 68), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q68[..., :64], k, v)    # head stride 68
    assert tfa.flash_attention.launches == before


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_take():
    """A head dim without an instantiation, a non-contiguous head dim and
    H not a multiple of KV are refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = tfa.flash_attention.launches
    q, k, v = _qkv_case(1, 64, 4, 2, 48, 0, torch.float32)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.flash_attention(q, k, v)
    wide, k, v = _qkv_case(1, 64, 4, 2, 128, 0, torch.float32)
    k, v = k[..., :64], v[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(wide[..., ::2], k.contiguous(), v.contiguous())
    q3, _, _ = _qkv_case(1, 64, 3, 2, 64, 0, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q3, k, v)
    assert tfa.flash_attention.launches == before


# ----------------------------------------------------------------------
# the RWKV-6 scan
# ----------------------------------------------------------------------
# times max|ref|, f32 y and state (chip_smoke.py's RWKV_F32_TOL: at most
# 2.0e-7 measured on an H100 SXM, 700 W)
RWKV_REL_TOL = 1e-6


def _rwkv_case(b, s, h, hd, seed, dtype, per_seq_u=False):
    """r, k, v ~ N(0, 0.5²) in ``dtype``; decays w = exp(-exp(x)) with x
    uniform in [-6, 0] (w from 0.37 to 0.9975: short and long memory);
    u ~ N(0, 0.3²); a nonzero initial state ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    cuda = lambda a, dt=torch.float32: torch.as_tensor(
        a.astype(np.float32)).to(dt).cuda()
    r, k, v = (cuda(rng.normal(size=(b, s, h, hd)) * 0.5, dtype)
               for _ in range(3))
    w = cuda(np.exp(-np.exp(rng.uniform(-6, 0, size=(b, s, h, hd)))))
    u = cuda(rng.normal(size=((b,) if per_seq_u else ()) + (h, hd)) * 0.3)
    st = cuda(rng.normal(size=(b, h, hd, hd)) * 0.1)
    return r, k, v, w, u, st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd,per_seq_u", [
    (1, 64, 2, 32, False),     # four whole chunks of 16 steps
    (2, 100, 3, 64, True),     # ragged S, a bonus per sequence
    (1, 1000, 4, 64, False),   # ragged, many chunks
    (2, 37, 1, 32, True),      # ragged, hd 32
    (3, 5, 2, 64, False),      # shorter than a chunk
])
def test_rwkv_kernel_matches_plain_version_on_the_card(dtype, b, s, h, hd,
                                                       per_seq_u):
    """The RWKV-6 kernel against ``rwkv_scan_ref`` on the same card inputs
    from a nonzero state: y and the final state within RWKV_REL_TOL of
    max|ref| (another summation order), bf16 y within one bf16 ulp beyond
    that bound; all finite, exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    r, k, v, w, u, st = _rwkv_case(b, s, h, hd, s + hd, dtype, per_seq_u)
    before = tscan.rwkv_scan.launches
    y, sf = tscan.rwkv_scan(r, k, v, w, u, st)
    torch.cuda.synchronize()
    assert tscan.rwkv_scan.launches == before + 1
    yr, sr = tscan.rwkv_scan_ref(r, k, v, w, u, st)
    assert y.dtype == dtype and y.shape == r.shape and sf.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sf).all())
    y_tol = RWKV_REL_TOL * float(yr.float().abs().max())
    if dtype == torch.float32:
        assert float((y - yr).abs().max()) <= y_tol
    else:
        assert bool(((y.float() - yr.float()).abs()
                     <= _bf16_ulp(yr.float()) + y_tol).all())
    assert float((sf - sr).abs().max()) <= RWKV_REL_TOL * float(
        sr.abs().max())


@pytest.mark.cuda
def test_rwkv_kernel_reads_strided_inputs_on_the_card():
    """r, k, v read in place as slices of one fused tensor, w as every
    other head of a wider one: the same result as contiguous copies, bit
    for bit (the same arithmetic on the same values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(4)
    fused = torch.as_tensor(rng.normal(size=(3, 200, 12, 64)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    r, k, v = fused[:, :, :4], fused[:, :, 4:8], fused[:, :, 8:]
    wide = torch.as_tensor(np.exp(-np.exp(rng.uniform(
        -6, 0, size=(3, 200, 8, 64)))).astype(np.float32)).cuda()
    w = wide[:, :, ::2]
    u = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32)).cuda()
    st = torch.zeros((3, 4, 64, 64), device="cuda")
    y, s = tscan.rwkv_scan(r, k, v, w, u, st)
    yc, sc = tscan.rwkv_scan(*(t.contiguous() for t in (r, k, v, w)), u, st)
    assert torch.equal(y, yc) and torch.equal(s, sc)


@pytest.mark.cuda
def test_rwkv_kernel_refuses_what_it_cannot_take():
    """A head dim without an instantiation, a bf16 w, a non-contiguous
    head dimension are refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = tscan.rwkv_scan.launches
    r, k, v, w, u, st = _rwkv_case(1, 8, 2, 16, 0, torch.float32)
    with pytest.raises(ValueError, match="head dim 16"):
        tscan.rwkv_scan(r, k, v, w, u, st)
    r, k, v, w, u, st = _rwkv_case(1, 8, 2, 32, 0, torch.float32)
    with pytest.raises(TypeError, match="float32"):
        tscan.rwkv_scan(r, k, v, w.to(torch.bfloat16), u, st)
    wide = torch.cat([r, r], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tscan.rwkv_scan(wide, k, v, w, u, st)
    assert tscan.rwkv_scan.launches == before


def _rwkv_gate(y, sf, yr, sr):
    y_tol = RWKV_REL_TOL * float(yr.float().abs().max())
    if y.dtype == torch.float32:
        ok = float((y - yr).abs().max()) <= y_tol
    else:
        ok = bool(((y.float() - yr.float()).abs()
                   <= _bf16_ulp(yr.float()) + y_tol).all())
    return ok and float((sf - sr).abs().max()) <= RWKV_REL_TOL * float(
        sr.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd", [
    (1, 40, 2, 64),     # B * H far below 132
    (4, 33, 40, 64),    # B * H = 160, above 132
    (3, 200, 70, 32),   # hd 32, B * H = 210
    (2, 15, 3, 32),     # shorter than a 16-step chunk
    (1, 16, 1, 64),     # exactly one chunk
])
def test_rwkv_kernel_under_every_column_block_on_the_card(dtype, b, s, h,
                                                          hd):
    """The C entry under each column block the kernel has (8, 16 and 32
    columns a block where they make whole warps, so a head's columns split
    at every edge the plan may choose) and the plan's own choice through
    the wrapper: within the gates of
    ``test_rwkv_kernel_matches_plain_version_on_the_card``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    r, k, v, w, u, st = _rwkv_case(b, s, h, hd, s + h, dtype)
    yr, sr = tscan.rwkv_scan_ref(r, k, v, w, u, st)
    y, sf = tscan.rwkv_scan(r, k, v, w, u, st)
    torch.cuda.synchronize()
    assert _rwkv_gate(y, sf, yr, sr)
    strides = (ctypes.c_longlong * 17)(
        *(x for t in (r, k, v, w, y) for x in t.stride()[:3]), 0,
        u.stride(0))
    for cb in tscan.COL_BLOCKS:
        threads = tscan._threads(hd, cb)
        if threads is None:
            continue   # no such block for this head dim
        plan = tscan.ScanPlan(cb, threads,
                              tscan._smem_bytes(hd, cb, r.element_size()),
                              hd // cb, 0)
        y2, s2 = torch.empty_like(y), torch.empty_like(sf)
        rc = tscan._lib().rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), st.data_ptr(), y2.data_ptr(), s2.data_ptr(),
            strides, 0 if dtype == torch.float32 else 1, b, s, h, hd,
            plan.c_args(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0, cb
        assert _rwkv_gate(y2, s2, yr, sr), cb


@pytest.mark.cuda
def test_rwkv_kernel_refuses_a_plan_for_other_operands_on_the_card():
    """A plan whose threads, shared bytes or column groups do not match
    its column block and head dim, or whose column block the kernel has
    no instantiation for, is refused before any launch; rows of r that do
    not start on 16-byte boundaries are refused by the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    r, k, v, w, u, st = _rwkv_case(1, 20, 2, 64, 1, torch.float32)
    y, sf = torch.empty_like(r), torch.empty_like(st)
    strides = (ctypes.c_longlong * 17)(
        *(x for t in (r, k, v, w, y) for x in t.stride()[:3]), 0,
        u.stride(0))
    good = tscan.scan_plan(1, 2, 64, torch.float32, 132)
    for fields in ((good.col_block, good.threads + 32, good.smem_bytes,
                    good.groups),
                   (good.col_block, good.threads, good.smem_bytes + 16,
                    good.groups),
                   (good.col_block, good.threads, good.smem_bytes, 1),
                   (4, 32, good.smem_bytes, 16)):
        rc = tscan._lib().rwkv_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), st.data_ptr(), y.data_ptr(), sf.data_ptr(),
            strides, 0, 1, 20, 2, 64, (ctypes.c_longlong * 4)(*fields),
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0, fields
    before = tscan.rwkv_scan.launches
    odd = torch.empty((1, 20, 2, 65), device="cuda")[..., 1:]
    odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        tscan.rwkv_scan(odd, k, v, w, u, st)
    assert tscan.rwkv_scan.launches == before


@pytest.mark.cuda
def test_rwkv_fleet_prefill_one_launch_per_layer_on_the_card():
    """A fleet of two nodes (their own inits, drawn on the card) through
    ``make_forward_prefill`` with ``use_ssm_kernel=True``: one launch per
    layer, the last-position logits finite and within 1e-4 of the plain
    scan body's (``use_ssm_kernel=False``; f32, hd 32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tt
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = get_smoke_config("rwkv6-3b")
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[tt.init_params(torch.Generator(device="cuda").manual_seed(i), cfg)
          for i in range(2)])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 3, 50)), device="cuda")
    before = tscan.rwkv_scan.launches
    got = make_forward_prefill(cfg, tt.ForwardOptions(use_ssm_kernel=True))(
        stacked, {"tokens": toks})
    assert tscan.rwkv_scan.launches == before + cfg.n_layers
    ref = make_forward_prefill(cfg, tt.ForwardOptions())(stacked,
                                                         {"tokens": toks})
    assert tscan.rwkv_scan.launches == before + cfg.n_layers
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4


# ----------------------------------------------------------------------
# MLA latent attention
# ----------------------------------------------------------------------
# times max|ref| (chip_smoke.py's MLA_F32_TOL, pinned from the card)
MLA_REL_TOL = 2e-5


def _mla_case(b, s, h, r, dr, seed, q_dtype, kv_dtype, t=None):
    """q_lat, q_rope ~ N(0, 1) · 2/√(r + dr) (logits of a few units) in
    ``q_dtype``; c_kv, k_rope ~ N(0, 1) in ``kv_dtype``."""
    rng = np.random.default_rng(seed)
    t = t or s
    qs = 2.0 / np.sqrt(r + dr)
    cuda = lambda shape, scale, dt: torch.as_tensor(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dt).cuda()
    return (cuda((b, s, h, r), qs, q_dtype), cuda((b, s, h, dr), qs, q_dtype),
            cuda((b, t, r), 1.0, kv_dtype), cuda((b, t, dr), 1.0, kv_dtype))


def _mla_gate(got, ref):
    """f32 out within MLA_REL_TOL·max|ref|; bf16 out within one bf16 ulp
    beyond that bound."""
    f32 = got.dtype == torch.float32
    got, ref = got.float(), ref.float()
    tol = MLA_REL_TOL * float(ref.abs().max())
    if f32:
        return float((got - ref).abs().max()) <= tol
    return bool(((got - ref).abs() <= _bf16_ulp(ref) + tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("b,s,t,h,r,dr", [
    (1, 200, 200, 4, 512, 64),    # deepseek-v2's ranks, ragged S
    (2, 64, 64, 2, 512, 64),      # whole tiles
    (2, 256, 100, 2, 512, 64),    # T < S, T not a multiple of 32
    (1, 100, 300, 2, 512, 64),    # T > S
    (1, 1024, 1024, 8, 512, 64),  # 16 query tiles of 64, 32 latent tiles
    (2, 256, 256, 4, 32, 16),     # smoke() ranks
    (1, 100, 100, 3, 32, 8),      # tests/test_serving.py's MLA ranks, ragged
    (3, 5, 5, 2, 32, 16),         # shorter than a tile
])
def test_mla_kernel_matches_plain_version_on_the_card(q_dtype, kv_dtype, b,
                                                      s, t, h, r, dr):
    """The latent-attention kernel against ``mla_attention_ref`` on the
    same card inputs, every (r, dr) and type pair it is instantiated for:
    f32 within MLA_REL_TOL·max|ref| (another summation order), bf16 out
    within one bf16 ulp beyond that; all finite, exactly one launch, of
    the kernel the rule names (``kernel_for``: ``mla_tc_kernel`` for a
    bf16 latent, ``mla_kernel`` for an f32 one) and none of the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = _mla_case(b, s, h, r, dr, s + r, q_dtype, kv_dtype, t=t)
    kernel = tmla.kernel_for(x[2])
    assert kernel == ("mla_tc_kernel" if kv_dtype == torch.bfloat16
                      else "mla_kernel")
    before = dict(tmla.mla_attention.kernel_launches)
    total = tmla.mla_attention.launches
    got = tmla.mla_attention(*x)
    torch.cuda.synchronize()
    after = tmla.mla_attention.kernel_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kernel) for k in after}
    assert tmla.mla_attention.launches == total + 1
    ref = tmla.mla_attention_ref(*x)
    assert got.dtype == q_dtype and got.shape == (b, s, h, r)
    assert bool(torch.isfinite(got).all())
    assert _mla_gate(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [40, 97, 300])
def test_mla_kernel_with_other_latent_lengths_on_the_card(t):
    """T != S (S = 128): the kernel masks t <= s over the T real latent
    rows, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = _mla_case(2, 128, 3, 512, 64, t, torch.float32, torch.bfloat16, t=t)
    assert _mla_gate(tmla.mla_attention(*x), tmla.mla_attention_ref(*x))


@pytest.mark.cuda
def test_mla_kernel_reads_strided_inputs_on_the_card():
    """c_kv and k_rope read in place as slices of one (B, T, r + dr)
    tensor, q_lat and q_rope as slices of one (B, S, H, r + dr): the same
    result as contiguous copies, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(5)
    q = torch.as_tensor((rng.normal(size=(2, 150, 4, 576)) * 0.08).astype(
        np.float32)).cuda()
    kv = torch.as_tensor(rng.normal(size=(2, 150, 576)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    x = (q[..., :512], q[..., 512:], kv[..., :512], kv[..., 512:])
    got = tmla.mla_attention(*x)
    assert torch.equal(got, tmla.mla_attention(*(a.contiguous() for a in x)))
    assert _mla_gate(got, tmla.mla_attention_ref(*x))


@pytest.mark.cuda
def test_mla_kernel_refuses_what_it_cannot_take():
    """(r, dr) without an instantiation, mixed types it has no case for,
    a non-contiguous last dimension and latent rows off 16-byte boundaries
    are refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = tmla.mla_attention.launches
    x = _mla_case(1, 16, 2, 64, 16, 0, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="instantiation"):
        tmla.mla_attention(*x)
    ql, qr, ck, kr = _mla_case(1, 16, 2, 32, 16, 0, torch.bfloat16,
                               torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        tmla.mla_attention(ql, qr, ck, kr)
    ql, qr, ck, kr = _mla_case(1, 16, 2, 32, 16, 0, torch.float32,
                               torch.float32)
    wide = torch.cat([ck, ck], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tmla.mla_attention(ql, qr, wide, kr)
    odd = torch.cat([ck[..., :1], ck, kr], -1)   # rows of 49 f32 values
    with pytest.raises(ValueError, match="16-byte"):
        tmla.mla_attention(ql, qr, odd[..., 1:33], odd[..., 33:])
    assert tmla.mla_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_mla_tc_kernel_reads_strided_inputs_on_the_card(q_dtype):
    """c_kv and k_rope sliced from one (B, T, 576) bf16 tensor and q_lat,
    q_rope from one (B, S, H, 576), T != S: read in place by the
    tensor-core kernel, bit for bit the result of contiguous copies, and
    within the gate of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(6)
    q = torch.as_tensor((rng.normal(size=(2, 190, 4, 576)) * 0.08).astype(
        np.float32)).to(q_dtype).cuda()
    kv = torch.as_tensor(rng.normal(size=(2, 170, 576)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    x = (q[..., :512], q[..., 512:], kv[..., :512], kv[..., 512:])
    tc = tmla.mla_attention.kernel_launches["mla_tc_kernel"]
    got = tmla.mla_attention(*x)
    assert torch.equal(got, tmla.mla_attention(*(a.contiguous() for a in x)))
    assert tmla.mla_attention.kernel_launches["mla_tc_kernel"] == tc + 2
    assert _mla_gate(got, tmla.mla_attention_ref(*x))


@pytest.mark.cuda
def test_mla_tc_kernel_refuses_before_any_launch_on_the_card():
    """A bf16 latent whose rows are off 16-byte boundaries, ranks without
    an instantiation and a q type the kernel has no case for are refused
    before any launch of either kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    before = dict(tmla.mla_attention.kernel_launches)
    ql, qr, ck, kr = _mla_case(1, 64, 2, 512, 64, 1, torch.float32,
                               torch.bfloat16)
    odd = torch.cat([ck[..., :1], ck, kr], -1)   # rows of 577 bf16 values
    with pytest.raises(ValueError, match="16-byte"):
        tmla.mla_attention(ql, qr, odd[..., 1:513], odd[..., 513:])
    with pytest.raises(ValueError, match="instantiation"):
        tmla.mla_attention(*_mla_case(1, 64, 2, 256, 64, 2, torch.float32,
                                      torch.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        tmla.mla_attention(ql.double(), qr.double(), ck, kr)
    assert tmla.mla_attention.kernel_launches == before


@pytest.mark.cuda
def test_mla_fleet_prefill_one_launch_per_layer_on_the_card():
    """A fleet of two nodes (their own inits, drawn on the card) of
    ``tests/test_serving.py``'s MLA config without experts, through
    ``make_forward_prefill`` with ``attn_impl="pallas"``: one launch per
    layer, the last-position logits finite and within 1e-4 of the plain
    chunked prefill's (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tt
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = ModelConfig(name="mla", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
                      use_mla=True, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, n_experts=0,
                      dtype="float32", param_dtype="float32")
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[tt.init_params(torch.Generator(device="cuda").manual_seed(i), cfg)
          for i in range(2)])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 3, 64)), device="cuda")
    before = tmla.mla_attention.launches
    got = make_forward_prefill(cfg, tt.ForwardOptions(attn_impl="pallas"))(
        stacked, {"tokens": toks})
    assert tmla.mla_attention.launches == before + cfg.n_layers
    ref = make_forward_prefill(cfg, tt.ForwardOptions(attn_impl="chunked"))(
        stacked, {"tokens": toks})
    assert tmla.mla_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,m,n,r", [
    (33, 1, 100_352, 33),   # the FFN's first leaf: the 16-byte path
    (5, 513, 129, None),    # ragged, rows off 16-byte boundaries, R = 1
    (33, 1, 1, 33),         # a one-value leaf (VGG-16's pool markers)
    (7, 3, 37, 3),          # odd N, R not a multiple of the row group
    (4, 2, 1024, 20),       # R = 20 over K = 4 on the streaming kernel
    (33, 1, 4096, None),    # R = 1 on the streaming kernel
    (33, 1, 2048, 64),      # R = 64: one row block of 6 groups
    (400, 1, 1000, 70)])    # two row blocks, 9 chunks, C a slice a stage
def test_gossip_mix_kernel_equals_plain_version_on_the_card(dtype, k, m, n,
                                                           r):
    """The K-way MAC against its plain version bit for bit (the same
    unfused f32 multiply and add in ascending k), on both of its paths
    (the streaming kernel for contiguous 16-byte slabs, ``rows_kernel``
    for the rest), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(k + m + n)
    blocks = torch.as_tensor(rng.normal(size=(k, m, n)).astype(np.float32)
                             ).to(dtype).cuda()
    w = rng.random((k,) if r is None else (r, k)).astype(np.float32)
    w = torch.as_tensor(w / w.sum(-1, keepdims=True)).cuda()
    before = tk.gossip_mix.launches
    got = tk.gossip_mix(blocks, w)
    torch.cuda.synchronize()
    assert tk.gossip_mix.launches == before + 1
    assert got.dtype == dtype
    assert tuple(got.shape) == ((m, n) if r is None else (r, m, n))
    assert torch.equal(got, tk.gossip_mix_ref(blocks, w))


@pytest.mark.cuda
def test_gossip_mix_kernel_reads_strided_and_offset_slabs_on_the_card():
    """Leaves that are views of a plane (slab stride = the plane's row
    stride, a column offset off 16 bytes, a strided middle dimension) are
    read in place, without a copy, and equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(5)
    plane = torch.as_tensor(rng.normal(size=(9, 1000)).astype(np.float32)
                            ).cuda()
    w = torch.as_tensor(rng.random((9, 9)).astype(np.float32)).cuda()
    for blocks in (plane[:, 4:516].reshape(9, 1, 512),        # aligned view
                   plane[:, 3:403].reshape(9, 20, 20),        # off 16 bytes
                   plane[:, :600].reshape(9, 20, 30)[:, :, :25]):  # strided
        got = tk.gossip_mix(blocks, w)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.gossip_mix_ref(blocks, w))
    with pytest.raises(ValueError, match="contiguous"):
        tk.gossip_mix(plane[:, :600].reshape(9, 20, 30).transpose(1, 2), w)


@pytest.mark.cuda
def test_mix_dense_rows_makes_one_launch_a_leaf_on_the_card():
    """``mix_dense_rows`` over a ragged 4-leaf tree (N = 128·56, 96·31,
    129 and 1) and over the FFN's six leaves: exactly n_leaves launches,
    each leaf equal to the plain fan-out and within 1e-5·max|ref| of the
    dense einsum (another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import tree as tree_util
    from repro_torch.benchmarks.gossip_cost import model_params
    from repro_torch.core.mixing import mix_dense

    gen = torch.Generator(device="cuda").manual_seed(0)
    ragged = {"w_big": torch.randn(8, 56, 128, generator=gen, device="cuda"),
              "w_mid": torch.randn(8, 31, 96, generator=gen, device="cuda"),
              "bias": torch.randn(8, 129, generator=gen, device="cuda"),
              "scale": torch.randn(8, generator=gen, device="cuda")}
    for params, n in ((ragged, 8), (model_params("ffn", 33, "cuda", gen), 33)):
        c = torch.softmax(torch.randn(n, n, generator=gen, device="cuda"), 1)
        before = tk.gossip_mix.launches
        got = tk.mix_dense_rows(params, c)
        torch.cuda.synchronize()
        leaves = tree_util.leaves(params)
        assert tk.gossip_mix.launches == before + len(leaves)
        plain = tree_util.tree_map(
            lambda x: tk.gossip_mix_ref(x.reshape(n, 1, -1), c
                                        ).reshape(x.shape), params)
        dense = mix_dense(params, c)
        for a, b, d in zip(tree_util.leaves(got), tree_util.leaves(plain),
                           tree_util.leaves(dense)):
            assert torch.equal(a, b)
            assert float((a - d).abs().max()) <= 1e-5 * float(d.abs().max())
