"""The RWKV-6 scan kernel's launch plan (``kernels/ssm_scan.py``
``scan_plan``, read by ``csrc/ssm_scan.cu`` ``rwkv_kernel``) on the CPU:
its choice and geometry, its refusals, a walk of the kernel's schedule
(column blocks, a thread's rows, the prep pass's rows, the copies, the
reduce-scatter's lanes), and the kernel's summation order emulated in
torch f32 against ``rwkv_scan_ref``.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssm_scan as tscan

torch.set_num_threads(2)

STEPS = tscan.CHUNK_STEPS
# times max|ref| (tests/test_torch_cuda.py's RWKV_REL_TOL)
RWKV_REL_TOL = 1e-6


ROWS, COLS = tscan.ROWS_PER_THREAD, tscan.COLS_PER_THREAD


def _shape(hd, cb):
    """Parts of a column group, threads, prep threads a step, prep rows
    a thread, steps a reduce-scatter."""
    p = hd // ROWS
    nt = cb // COLS * p
    q = nt // STEPS
    return p, nt, q, hd // q, p // COLS


def _rows(hd, p_):
    """A thread's state rows: 4 (c P + p) + e, c < ROWS / 4, e < 4."""
    p = hd // ROWS
    return [4 * (c * p + p_) + e for c in range(ROWS // 4) for e in range(4)]


def _blocks(hd):
    return [cb for cb in tscan.COL_BLOCKS if tscan._threads(hd, cb)]


@pytest.mark.parametrize("hd,cb", [(hd, cb) for hd in tscan.HEAD_DIMS
                                   for cb in _blocks(hd)])
def test_schedule_covers_the_state_and_the_chunk_once(hd, cb):
    """Over a head's column groups and a block's threads, every state
    element (i, j) is one thread's; a reduce-scatter's lanes leave every
    (step, column) of a group one thread's; over the prep threads every
    (step, row) of a chunk is one thread's, Q threads a step in one warp;
    the copies of a chunk land every 16-byte piece of r, k, w and the
    block's v columns once; the y tile leaves as whole 16-byte pieces."""
    p, nt, q, rpt, kt = _shape(hd, cb)
    owner = np.zeros((hd, hd), np.int64)
    y_owner = np.zeros((kt, hd), np.int64)
    for g in range(hd // cb):
        for tid in range(nt):
            jl = tid // p * COLS
            for d in range(COLS):
                for i in _rows(hd, tid % p):
                    owner[i, g * cb + jl + d] += 1
            y_owner[(tid % p) // COLS, g * cb + jl + (tid % p) % COLS] += 1
    assert (owner == 1).all() and (y_owner == 1).all()
    assert kt * COLS == p and STEPS % kt == 0
    prep = np.zeros((STEPS, hd), np.int64)
    for tid in range(nt):
        t, row0 = tid // q, (tid % q) * rpt
        prep[t, row0:row0 + rpt] += 1
        assert (tid // 32) == ((t * q) // 32)   # a step's threads: one warp
    assert (prep == 1).all() and rpt % 4 == 0 and nt % 32 == 0
    for itemsize in (2, 4):
        e = 16 // itemsize
        rv, vv = hd // e, cb // e
        seen = set()
        for qq in range(2 * STEPS * rv):
            seen.add((qq // (STEPS * rv), (qq // rv) % STEPS, qq % rv))
        assert len(seen) == 2 * STEPS * rv
        assert vv >= 1 and cb % e == 0


@pytest.mark.parametrize("p", [4, 8])
def test_reduce_scatter_leaves_each_lane_its_step(p):
    """The shuffles of ``reduce_scatter``, lane by lane: after the halvings
    lane l holds the sum over the P lanes of step l."""
    rng = np.random.default_rng(p)
    parts = rng.integers(0, 1000, size=(p, p))   # [lane][step]
    v = [list(parts[lane]) for lane in range(p)]
    m = p // 2
    while m >= 1:
        upper = [bool(lane & m) for lane in range(p)]
        send = [[v[l][q] if upper[l] else v[l][q + m] for q in range(m)]
                for l in range(p)]
        v = [[(v[l][q + m] if upper[l] else v[l][q]) + send[l ^ m][q]
              for q in range(m)] for l in range(p)]
        m //= 2
    assert [v[lane][0] for lane in range(p)] == list(parts.sum(0))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _tree(x, dim):
    """Sum over ``dim`` pairing its halves first, as xor shuffles from the
    highest lane bit down add."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _emulate(r, k, v, w, u, state, cb):
    """rwkv_kernel's arithmetic in f32 on the CPU: chunks of 16 steps
    padded with w = 1, k = r = v = 0 past S; the bonus a_t from the prep
    threads' fma chains and their xor reduction; a thread's two 4-row fma
    chains of r s, added, the state's fma, and the P threads'
    reduce-scatter; y = fma(v, a_t, sum)."""
    b, s, h, hd = r.shape
    p, nt, q, rpt, kt = _shape(hd, cb)
    n_chunks = -(-s // STEPS)
    pad = n_chunks * STEPS - s
    f = lambda x, fill: torch.cat(
        [x.float(), torch.full((b, pad, h, hd), fill)], 1)
    r, k, v, w = f(r, 0.0), f(k, 0.0), f(v, 0.0), f(w, 1.0)
    uu = (u if u.ndim == 3 else u[None]).float().expand(b, h, hd)
    c4 = ROWS // 4
    st = state.float().clone().view(b, h, c4, p, 4, hd)
    ys = []
    for c0 in range(0, n_chunks * STEPS, STEPS):
        for g0 in range(0, STEPS, kt):
            if c0 + g0 >= s:
                break
            for t in range(c0 + g0, c0 + g0 + kt):
                ru = (r[:, t] * uu).view(b, h, q, rpt)
                kk = k[:, t].view(b, h, q, rpt)
                part = torch.zeros((b, h, q))
                for e in range(rpt):
                    part = _fma(ru[..., e], kk[..., e], part)
                a_t = _tree(part, 2)
                rr = r[:, t].view(b, h, c4, p, 4, 1)
                kv = k[:, t].view(b, h, c4, p, 4, 1) * v[:, t, :, None, None,
                                                        None, :]
                wt = w[:, t].view(b, h, c4, p, 4, 1).expand_as(st)
                acc = torch.zeros((b, h, c4, p, hd))
                for e in range(4):
                    acc = _fma(rr[:, :, :, :, e].expand_as(acc),
                               st[:, :, :, :, e], acc)
                    st[:, :, :, :, e] = _fma(wt[:, :, :, :, e],
                                             st[:, :, :, :, e],
                                             kv[:, :, :, :, e])
                ysum = _tree(acc[:, :, 0] + acc[:, :, 1] if c4 == 2
                             else acc[:, :, 0], 2)
                ys.append(_fma(v[:, t], a_t[..., None].expand(b, h, hd),
                               ysum))
    y = torch.stack(ys, 1)[:, :s]
    return y, st.view(b, h, hd, hd)


@pytest.mark.parametrize("hd,cb", [(32, 16), (64, 8), (64, 16), (32, 32)])
@pytest.mark.parametrize("s", [5, 37])
def test_summation_order_stays_within_the_gate(hd, cb, s):
    """The kernel's order of sums, emulated in f32 (its FMAs rounded once
    through float64), from a nonzero state with a bonus per sequence, stays
    within RWKV_REL_TOL of max|ref| of ``rwkv_scan_ref`` in y and in the
    final state (the padded steps past S leave the state as it was).
    Measured on these cases: at most 0.245 of the gate in y and 0.211 in
    the state."""
    rng = np.random.default_rng(hd + s + cb)
    b, h = 2, 3
    t = lambda *shape, scale=1.0: torch.as_tensor(
        (rng.normal(size=shape) * scale).astype(np.float32))
    r, k, v = (t(b, s, h, hd, scale=0.5) for _ in range(3))
    w = torch.as_tensor(np.exp(-np.exp(rng.uniform(
        -6, 0, size=(b, s, h, hd)))).astype(np.float32))
    u = t(b, h, hd, scale=0.3)
    st = t(b, h, hd, hd, scale=0.1)
    y, sf = _emulate(r, k, v, w, u, st, cb)
    yr, sr = tscan.rwkv_scan_ref(r, k, v, w, u, st)
    y_use = float((y - yr).abs().max()) / (RWKV_REL_TOL *
                                           float(yr.abs().max()))
    s_use = float((sf - sr).abs().max()) / (RWKV_REL_TOL *
                                            float(sr.abs().max()))
    assert y_use <= 1.0 and s_use <= 1.0, (y_use, s_use)


def test_plan_at_the_rwkv6_prefill():
    """(2, 4096, 40, 64): 16 columns a block in bf16 and f32 (320 blocks of
    64 threads, three an SM, all resident); a one-warp block is never
    chosen."""
    for dtype in (torch.bfloat16, torch.float32):
        pl = tscan.scan_plan(2, 40, 64, dtype, 132)
        assert (pl.col_block, pl.threads, pl.groups) == (16, 64, 4)
        assert pl.blocks_per_sm >= 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", tscan.HEAD_DIMS)
@pytest.mark.parametrize("bh", [(1, 1), (2, 8), (3, 4), (2, 40), (64, 40),
                                (65535, 1)])
def test_plan_geometry(bh, hd, dtype):
    """Every plan is a column block the kernel has, whole warps, its
    shared memory the kernel's layout (a 3-stage ring of raw inputs, the
    f32 work tiles, the y tile) within a block's limit, at least one block
    an SM; the C arguments in the entry's order."""
    b, h = bh
    pl = tscan.scan_plan(b, h, hd, dtype, 132)
    item = 4 if dtype == torch.float32 else 2
    assert pl.col_block in tscan.COL_BLOCKS and pl.col_block <= hd
    assert pl.groups * pl.col_block == hd
    assert pl.threads == pl.col_block // COLS * hd // ROWS
    assert pl.threads % 32 == 0 and tscan._threads(hd, pl.col_block)
    assert pl.threads >= tscan.MIN_THREADS
    stage = STEPS * (2 * hd * item + hd * 4 + pl.col_block * item)
    work = (2 * STEPS * hd + STEPS * pl.col_block + STEPS) * 4
    assert pl.smem_bytes == 3 * stage + work + STEPS * pl.col_block * 4
    assert pl.smem_bytes <= 232_448 and pl.blocks_per_sm >= 1
    assert list(pl.c_args()) == [pl.col_block, pl.threads, pl.smem_bytes,
                                 pl.groups]


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="head dim 16"):
        tscan.scan_plan(1, 1, 16, torch.float32, 132)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tscan.scan_plan(1, 1, 64, torch.float16, 132)
    with pytest.raises(ValueError, match="B, H >= 1"):
        tscan.scan_plan(0, 1, 64, torch.float32, 132)
