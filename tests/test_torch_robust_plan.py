"""The robust mix kernel's launch plan (``kernels/gossip_mix.py``
``robust_plan``, read by ``csrc/gossip_robust.cu`` ``robust_kernel``) on
the CPU: its geometry, its refusals, and a numpy walk of the kernel's
schedule (column tiles, warps' runs of (row, 32 or 64 columns) units, the ballot
compaction of a row's table, the count bucket, the stable in-place
insertion, the ascending unfused sums) against ``gossip_robust_ref``, bit
for bit.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import mixing as tmix
from repro_torch.kernels import gossip_mix as tk

torch.set_num_threads(2)

WARPS = tk.ROBUST_WARPS
H100_SMEM_PER_SM = 233_472


def _bf16(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _buckets(slots):
    b, out = 4, []
    while b <= slots:
        out.append(b)
        b *= 2
    return out


def _compact(w_row, idx_row, lowp):
    """The warp's table read: a lane a slot, 32 slots a pass; the ballot
    of w > 0 and the population count of the lower lanes place each
    occupied slot after those before it."""
    dmax = len(w_row)
    tw, ti, cnt = {}, {}, 0
    for d0 in range(0, dmax, 32):
        lanes = range(d0, min(d0 + 32, dmax))
        wv = {d: (_bf16(w_row[d])[()] if lowp else np.float32(w_row[d]))
              for d in lanes}
        mask = sum(1 << (d - d0) for d in lanes if wv[d] > 0)
        for d in lanes:
            lane = d - d0
            if wv[d] > 0:
                at = cnt + bin(mask & ((1 << lane) - 1)).count("1")
                tw[at], ti[at] = wv[d], int(idx_row[d])
        cnt += bin(mask).count("1")
    return [tw[s] for s in range(cnt)], [ti[s] for s in range(cnt)]


def _row(vals, self_vals, tw, ti, op, trim_k, lowp, slots):
    """One unit's columns (vectorised over them), as robust_kernel's lanes
    compute them: every loop stops at the row's count."""
    f32 = np.float32
    rnd = _bf16 if lowp else (lambda x: np.asarray(x, f32))
    big = _bf16(1e30)[()] if lowp else f32(1e30)
    cnt = len(tw)
    bucket = next(b for b in _buckets(slots) if cnt <= b)
    assert cnt <= bucket <= slots
    key, wt = [], []
    for s in range(cnt):
        x = vals[ti[s]]
        # fminf keeps the number against NaN: NaN -> big, then the clamp
        key.append(np.fmax(np.fmin(x, big), -big).astype(f32))
        wt.append(np.full(x.shape, tw[s], f32))
    for s in range(1, cnt):
        x, wx = key[s], wt[s]
        gt_above = np.ones(x.shape, bool)
        for j in range(s, 0, -1):
            gt = key[j - 1] > x
            kj = np.where(gt, key[j - 1], np.where(gt_above, x, key[j]))
            wj = np.where(gt, wt[j - 1], np.where(gt_above, wx, wt[j]))
            key[j], wt[j] = kj, wj
            gt_above = gt
        key[0] = np.where(gt_above, x, key[0])
        wt[0] = np.where(gt_above, wx, wt[0])
    if op == "median":
        if cnt == 0:
            return self_vals
        return rnd(f32(0.5) * rnd(key[(cnt - 1) // 2] + key[cnt // 2]))
    mass = np.zeros(self_vals.shape, f32)
    num = np.zeros(self_vals.shape, f32)
    for j in range(trim_k, cnt - trim_k):
        mass = rnd(mass + wt[j])
        num = rnd(num + rnd(wt[j] * key[j]))
    with np.errstate(divide="ignore", invalid="ignore"):
        q = rnd(num / np.where(mass > 0, mass, f32(1)))
    return np.where(mass > 0, q, self_vals)


def _emulate(plane, w, idx, op, trim_k, f32, plan):
    """robust_kernel's schedule over the whole plane: every block's tile,
    cut into (row, 32 · cols columns) units, each warp a run of them row
    by row, reading a row's table when its run reaches the row."""
    n, p = plane.shape
    lowp = not f32 and plane.dtype == torch.bfloat16
    vals = plane.float().numpy()
    w, idx = w.numpy(), idx.numpy()
    out = np.zeros((n, p), np.float32)
    hits = np.zeros((n, p), np.int64)
    width = 32 * tk.robust_cols(plan.slots, op)
    groups = plan.tile_cols // width
    per_warp = -(-n * groups // WARPS)
    for blk in range(plan.grid):
        c0 = blk * plan.tile_cols
        for warp in range(WARPS):
            row = None
            for unit in range(warp * per_warp,
                              min(n * groups, (warp + 1) * per_warp)):
                i, g = divmod(unit, groups)
                if i != row:
                    tw, ti = _compact(w[i], idx[i], lowp)
                    row = i
                cols = np.arange(c0 + width * g, c0 + width * (g + 1))
                cols = cols[cols < p]
                if not len(cols):
                    continue
                out[i, cols] = _row(vals[:, cols], vals[i, cols], tw, ti, op,
                                    trim_k, lowp, plan.slots)
                hits[i, cols] += 1
    assert (hits == 1).all()
    return torch.as_tensor(out).to(plane.dtype)


def _same(a, b):
    a, b = a.float(), b.float()
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _counts_case(counts, dmax, p, seed):
    """One row per count in ``counts`` (plus rows to index), each with that
    many occupied slots scattered over a ``dmax``-slot table whose
    indices repeat source rows (exact ties with other weights); plane
    rows 1, 2 and 3 NaN, +Inf, -Inf in part, rows 5 and 6 equal."""
    rng = np.random.default_rng(seed)
    n = max(len(counts), 8)
    idx = rng.integers(0, n, size=(n, dmax)).astype(np.int32)
    w = np.zeros((n, dmax), np.float32)
    for i in range(n):
        cnt = counts[i % len(counts)]
        slots = rng.choice(dmax, size=cnt, replace=False)
        w[i, slots] = rng.random(cnt).astype(np.float32) + 0.05
    plane = rng.standard_normal((n, p)).astype(np.float32)
    plane[1] = np.nan
    plane[2, ::2] = np.inf
    plane[3, 1::3] = -np.inf
    plane[6] = plane[5]
    return plane, torch.as_tensor(w), torch.as_tensor(idx)


EDGE_COUNTS = (1, 4, 5, 8, 9, 16, 17, 64)


@pytest.mark.parametrize("dtype,f32", [(torch.float32, True),
                                       (torch.bfloat16, True),
                                       (torch.bfloat16, False)])
@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("trimmed", 2),
                                       ("median", 0)])
def test_schedule_equals_plain_version_at_bucket_edges(dtype, f32, op,
                                                       trim_k):
    """Rows with 0, 1, 4, 5, 8, 9, 16, 17 and 64 occupied slots (every
    bucket's edges, 64 slots a table) on a plane with NaN and ±Inf rows and
    a ragged last tile: the kernel's schedule equals the plain version bit
    for bit (rows of 0 to 2 · trim_k slots keep their own values)."""
    plane, w, idx = _counts_case((0,) + EDGE_COUNTS, 64, 70, 1)
    pt = torch.as_tensor(plane).to(dtype)
    plan = tk.robust_plan(pt.shape[0], pt.shape[1], 64, dtype, op)
    assert plan.slots == 64 and plan.staged
    got = _emulate(pt, w, idx, op, trim_k, f32, plan)
    ref = tk.gossip_robust_ref(pt, w, idx, op, trim_k, f32)
    assert _same(got, ref)


@pytest.mark.parametrize("dmax,counts", [(8, (1, 4, 5, 8)),
                                         (16, (1, 4, 5, 8, 9, 16)),
                                         (32, (3, 9, 17, 31, 32))])
@pytest.mark.parametrize("tile", tk.ROBUST_TILES)
@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("median", 0)])
def test_schedule_equals_plain_version_for_each_tile_and_width(dmax, counts,
                                                               tile, op,
                                                               trim_k):
    """Narrower tables (8, 16 and 32 slots, their buckets stopping at the
    instantiation; two columns a lane for the median up to 16 slots)
    under every tile width a unit divides: bit for bit the plain version,
    every (row, column) computed by exactly one unit."""
    if tile % (32 * tk.robust_cols(dmax, op)):
        tile *= 2   # the narrowest tile a two-column unit takes
    plane, w, idx = _counts_case(counts, dmax, 300, dmax + tile)
    pt = torch.as_tensor(plane)
    best = tk.robust_plan(pt.shape[0], 300, dmax, torch.float32, op)
    plan = tk.RobustPlan(tile, True, best.slots, -(-300 // tile),
                         0, best.blocks_per_sm)
    assert plan.slots == dmax
    got = _emulate(pt, w, idx, op, trim_k, True, plan)
    assert _same(got, tk.gossip_robust_ref(pt, w, idx, op, trim_k))


def test_schedule_keeps_an_all_trimmed_row():
    """trim_k = 2 on rows of 1 to 4 occupied slots drops every value: each
    falls back to its own raw row, a NaN included."""
    plane, w, idx = _counts_case((1, 2, 3, 4), 8, 40, 3)
    plane[0, 7] = np.nan
    pt = torch.as_tensor(plane)
    plan = tk.robust_plan(pt.shape[0], 40, 8, torch.float32)
    got = _emulate(pt, w, idx, "trimmed", 2, True, plan)
    assert _same(got, torch.as_tensor(plane))
    assert _same(got, tk.gossip_robust_ref(pt, w, idx, "trimmed", 2))


def test_schedule_on_the_recorded_hypothesis_case():
    """The example Hypothesis recorded against the reference (seed 0, n = 4,
    p = 2, trimmed with trim_k = 1; ``test_torch_robust.py``
    ``test_hypothesis_case_seed0_n4_p2_trimmed``): the kernel's schedule
    equals the plain version bit for bit."""
    from tests.test_robust_mix import _random_case

    flat, c, idx, msk = _random_case(0, 4, 2)
    w = tmix.edge_weights(torch.as_tensor(c), torch.as_tensor(idx),
                          torch.as_tensor(msk))
    idx = torch.as_tensor(idx, dtype=torch.int32)
    pt = torch.as_tensor(flat)
    plan = tk.robust_plan(4, 2, idx.shape[1], torch.float32)
    got = _emulate(pt, w, idx, "trimmed", 1, True, plan)
    assert _same(got, tk.gossip_robust_ref(pt, w, idx, "trimmed", 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4, 33, 64, 700, 880, 1000, 2000])
@pytest.mark.parametrize("p", [0, 1, 37, 1000, 14_982_479])
def test_plan_geometry(n, p, dtype):
    """The tiles cover the columns exactly once; a staged tile of n rows
    lets two blocks share an SM, and is the widest that does; the plan
    gathers from global memory only where no tile of 32 columns fits;
    shared memory is the tile plus 8 bytes a slot a warp."""
    b = 4 if dtype == torch.float32 else 2
    for dmax, op in ((1, "median"), (8, "trimmed"), (9, "median"),
                     (16, "trimmed"), (16, "median"), (33, "median"),
                     (64, "trimmed")):
        pl = tk.robust_plan(n, p, dmax, dtype, op)
        assert pl.tile_cols in tk.ROBUST_TILES
        assert pl.grid * pl.tile_cols >= p > (pl.grid - 1) * pl.tile_cols \
            or p == pl.grid == 0
        assert pl.slots == min(s for s in tk.ROBUST_SLOTS if s >= dmax)
        table = WARPS * pl.slots * 8
        unit = 32 * tk.robust_cols(pl.slots, op)
        fits = [t for t in tk.ROBUST_TILES if t % unit == 0
                and 2 * (n * t * b + table + 1024) <= H100_SMEM_PER_SM]
        if fits:
            assert pl.staged and pl.tile_cols == max(fits)
            assert pl.smem_bytes == n * pl.tile_cols * b + table
            assert pl.blocks_per_sm >= 2
        else:
            assert not pl.staged and pl.smem_bytes == table
        assert pl.tile_cols * b % 16 == 0 and pl.tile_cols % unit == 0
        assert list(pl.c_args()) == [pl.tile_cols, int(pl.staged), pl.slots,
                                     pl.grid, pl.smem_bytes]


def test_plan_at_the_paper_size():
    """n = 33 on BA(33, 2) (16 slots): 256 columns a block, staged, 33.8 KB
    of plane a block in f32, for both rules (the median two columns a
    lane); the VGG-16 plane is 58,526 tiles."""
    for op in ("trimmed", "median"):
        pl = tk.robust_plan(33, 14_982_479, 16, torch.float32, op)
        assert (pl.tile_cols, pl.staged, pl.slots) == (256, True, 16)
        assert pl.grid == 58_526
        assert pl.smem_bytes == 33 * 256 * 4 + 8 * 16 * 8
    assert tk.robust_cols(16, "median") == 2
    assert tk.robust_cols(16, "trimmed") == tk.robust_cols(32, "median") == 1


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="widest kernel instantiation"):
        tk.robust_plan(65, 10, 65, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.robust_plan(4, 10, 4, torch.float16)
    with pytest.raises(ValueError, match="n >= 1"):
        tk.robust_plan(0, 10, 4, torch.float32)
