"""The streaming gossip-mix kernel's launch plan (``kernels/gossip_mix.py``
``mix_plan``, read by ``csrc/gossip_mix.cu`` ``stream_kernel``) on the CPU:
its geometry, its shared-memory layout, and a numpy walk of the kernel's
schedule (blocks, ring steps, the coefficients' ``[k / 4][slot][4]``
layout, the zero-filled ragged edge) against ``W @ X``.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import gossip_mix as tk

torch.set_num_threads(2)

SIZES = (1, 5, 33, 70, 1024)
DTYPES = (torch.float32, torch.bfloat16)
H100_SMS = 132


def _row_of(pl, block, group, slot, n_rows):
    """The output row that thread group ``group`` of block ``block``
    holds in its ``slot``-th accumulator row, or None for a slot past the
    block's rows (stream_kernel's formula)."""
    row0 = (block % pl.row_blocks) * pl.rows_per_block
    i = group * tk.ROWS_PER_THREAD + slot
    return row0 + i if i < min(pl.rows_per_block, n_rows - row0) else None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_src", SIZES)
@pytest.mark.parametrize("n_rows", SIZES)
def test_plan_geometry(n_rows, n_src, dtype):
    """Every output row lies in exactly one consumer slot of its row
    block; the chunks cover the source rows; shared memory fits a block
    and every copy and region is 16-byte sized and aligned; the grid is
    whole row blocks of resident blocks."""
    pl = tk.mix_plan(n_rows, n_src, 14_982_479, dtype, H100_SMS)
    seen = []
    for block in range(pl.row_blocks):
        for group in range(pl.groups):
            for slot in range(tk.ROWS_PER_THREAD):
                row = _row_of(pl, block, group, slot, n_rows)
                if row is not None:
                    seen.append(row)
    assert sorted(seen) == list(range(n_rows))
    assert pl.rows_per_block <= tk.MAX_BLOCK_ROWS
    assert 1 <= pl.groups <= tk.MAX_GROUPS
    # no group is wholly past its block's rows (no idle warps)
    assert (pl.groups - 1) * tk.ROWS_PER_THREAD < pl.rows_per_block
    assert pl.chunks * pl.chunk >= n_src > (pl.chunks - 1) * pl.chunk
    assert pl.chunk <= tk.MAX_CHUNK
    assert pl.chunks == 1 or pl.chunk % 4 == 0
    assert pl.smem_bytes <= 232_448
    assert pl.smem_bytes == pl.w_bytes(n_src) + pl.stages * (
        pl.x_stage_bytes + pl.w_stage_bytes)
    assert 3 <= pl.stages <= tk.MAX_STAGES
    for nbytes in (pl.row_bytes, pl.x_stage_bytes, pl.w_stage_bytes,
                   pl.w_bytes(n_src)):
        assert nbytes % 16 == 0
    # a tile row is 64 or 128 16-byte copies, 1 or 2 a thread of a group
    assert pl.tile_cols * pl.itemsize == pl.row_bytes
    assert pl.row_bytes == pl.vecs * tk.GROUP_THREADS * tk.VEC_BYTES
    assert pl.vecs == (2 if dtype == torch.float32 and n_rows > 64 else 1)
    assert pl.x_stage_bytes <= tk.MAX_STAGE_ROW_BYTES
    assert pl.threads == pl.groups * tk.GROUP_THREADS <= 384
    assert pl.blocks_per_sm >= 1
    assert pl.grid % pl.row_blocks == 0
    assert pl.row_blocks <= pl.grid <= max(
        pl.row_blocks, H100_SMS * pl.blocks_per_sm)
    if pl.w_resident:
        assert pl.w_bytes(n_src) <= tk.W_RESIDENT_BYTES
    assert list(pl.c_args()) == [
        pl.rows_per_block, pl.row_blocks, pl.groups, pl.chunk, pl.chunks,
        pl.stages, int(pl.w_resident), pl.grid, pl.smem_bytes, pl.vecs,
        pl.experiments]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_at_the_paper_size(dtype):
    """n = 33: one row block of 3 groups of 11 rows, one chunk, C
    resident, two blocks an SM with at least 32 KB of loads in flight on
    each, the grid the SM count times two or the tile count (the FFN's
    bf16 plane: 232 tiles)."""
    for p in (118_282, 14_982_479):
        pl = tk.mix_plan(33, 33, p, dtype, H100_SMS)
        assert (pl.row_blocks, pl.groups, pl.chunks) == (1, 3, 1)
        assert pl.w_resident and pl.blocks_per_sm == 2
        assert pl.blocks_per_sm * (pl.stages - 1) * pl.x_stage_bytes >= 32768
        tiles = -(-p // pl.tile_cols)
        assert pl.grid == min(2 * H100_SMS, tiles)


def test_plan_grid_is_the_tile_count_when_fewer():
    """A plane with fewer column tiles than resident blocks launches one
    block a tile (a row block's worth each)."""
    pl = tk.mix_plan(33, 33, 1001, torch.float32, H100_SMS)
    assert pl.grid == 4
    pl = tk.mix_plan(70, 70, 515, torch.bfloat16, H100_SMS)
    assert pl.grid == pl.row_blocks * 2


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tk.mix_plan(0, 33, 10, torch.float32, H100_SMS)
    with pytest.raises(TypeError):
        tk.mix_plan(33, 33, 10, torch.float16, H100_SMS)


def _stage_coeffs(pl, w, row0, rows, k0, kn, kp):
    """The [k / 4][slot][4] coefficient layout stream_kernel stages, zero
    past the block's rows and the chunk's source rows."""
    slots = pl.slots
    e = np.arange(slots * kp)
    r = (e // 4) % slots
    k = (e // (slots * 4)) * 4 + e % 4
    inside = (r < rows) & (k < kn)
    out = np.zeros(slots * kp)
    out[inside] = w[row0 + r[inside], k0 + k[inside]]
    return out


def _walk(pl, w, x, p):
    """stream_kernel's schedule in numpy, block by block and step by
    step: what each stage copies (zero past column p, nothing read there),
    what each slot sums, which columns each block stores.  Returns the
    output (NaN where never written) and the highest column read."""
    n_rows, n_src = w.shape
    vec = tk.VEC_BYTES // pl.itemsize
    cols = pl.tile_cols
    slots = pl.slots
    n_tiles = -(-p // cols)
    lanes = pl.grid // pl.row_blocks
    out = np.full((n_rows, p), np.nan)
    max_read = -1
    for b in range(pl.grid):
        row0 = (b % pl.row_blocks) * pl.rows_per_block
        rows = min(pl.rows_per_block, n_rows - row0)
        lane = b // pl.row_blocks
        steps = ((n_tiles - 1 - lane) // lanes + 1) * pl.chunks \
            if lane < n_tiles else 0
        resident = _stage_coeffs(pl, w, row0, rows, 0, n_src,
                                 -(-n_src // 4) * 4) if pl.w_resident \
            else None
        acc = np.zeros((slots, cols))
        for s in range(steps):
            c = s % pl.chunks
            tile = lane + (s // pl.chunks) * lanes
            k0 = c * pl.chunk
            kn = min(pl.chunk, n_src - k0)
            col0 = tile * cols
            xs = np.zeros((kn, cols))
            for v in range(tk.GROUP_THREADS * pl.vecs):
                col = col0 + v * vec
                left = p - col
                nel = vec if left >= vec else max(left, 0)
                if nel:
                    xs[:, v * vec:v * vec + nel] = x[k0:k0 + kn,
                                                     col:col + nel]
                    max_read = max(max_read, col + nel - 1)
            if pl.w_resident:
                ws = resident[(k0 // 4) * slots * 4:]
            else:
                ws = _stage_coeffs(pl, w, row0, rows, k0, kn,
                                   -(-pl.chunk // 4) * 4)
            for k in range(kn):
                wk = ws[(k // 4) * slots * 4 + np.arange(slots) * 4 + k % 4]
                acc += np.outer(wk, xs[k])
            if c == pl.chunks - 1:
                hi = min(col0 + cols, p)
                for slot in range(rows):
                    assert np.isnan(out[row0 + slot, col0:hi]).all()
                    out[row0 + slot, col0:hi] = acc[slot, :hi - col0]
                acc[:] = 0.0
    return out, max_read


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_rows,n_src,p,sms", [
    (1, 1, 37, H100_SMS),     # one row of 37: the ragged vector
    (5, 5, 37, H100_SMS),     # P under one tile
    (33, 33, 1001, 1),        # 4 f32 tiles (2 bf16) over 2 blocks
    (33, 33, 5000, 1),        # 20 f32 tiles (10 bf16) over 2 blocks
    (20, 4, 2048, H100_SMS),  # R != K
    (70, 70, 515, 1),         # two row blocks, two chunks, C resident
    (70, 400, 300, 1),        # C too wide to stay: a slice a stage
])
def test_kernel_schedule_computes_w_at_x(n_rows, n_src, p, sms, dtype):
    """Walking the kernel's schedule writes every output element once,
    equal to ``W @ X``, and reads no column at or past P."""
    rng = np.random.default_rng(n_rows + n_src + p)
    w = rng.random((n_rows, n_src))
    x = rng.normal(size=(n_src, p))
    pl = tk.mix_plan(n_rows, n_src, p, dtype, sms)
    got, max_read = _walk(pl, w, x, p)
    assert not np.isnan(got).any()
    assert max_read == p - 1
    np.testing.assert_allclose(got, w @ x, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# the experiment axis
# ----------------------------------------------------------------------
def _plan_before_the_experiment_axis(n_rows, n_src, p, dtype, sms):
    """``mix_plan`` as it was before the experiment axis, kept here to
    pin that ``experiments=1`` changes no launch."""
    itemsize = 4 if dtype == torch.float32 else 2
    row_blocks = -(-n_rows // tk.MAX_BLOCK_ROWS)
    rows_per_block = -(-n_rows // row_blocks)
    groups = -(-rows_per_block // tk.ROWS_PER_THREAD)
    vecs = 2 if itemsize == 4 and n_rows > tk.MAX_BLOCK_ROWS else 1
    row_bytes = vecs * tk.GROUP_THREADS * tk.VEC_BYTES
    chunks = -(-n_src // min(tk.MAX_CHUNK,
                             tk.MAX_STAGE_ROW_BYTES // row_bytes))
    r4 = lambda v: -(-v // 4) * 4
    chunk = n_src if chunks == 1 else r4(-(-n_src // chunks))
    chunks = -(-n_src // chunk)
    slots = groups * tk.ROWS_PER_THREAD
    w_resident = slots * r4(n_src) * 4 <= tk.W_RESIDENT_BYTES
    w_bytes = slots * r4(n_src) * 4 if w_resident else 0
    stage = chunk * row_bytes + (0 if w_resident else slots * r4(chunk) * 4)
    threads = groups * tk.GROUP_THREADS
    best = None
    for stages in range(3, tk.MAX_STAGES + 1):
        smem = w_bytes + stages * stage
        if smem > tk.SMEM_PER_BLOCK:
            break
        bps = tk._blocks_per_sm(threads, smem)
        key = (bps, bps * (stages - 1) * stage)
        if bps and (best is None or key > best[0]):
            best = (key, stages, smem)
    (bps, _), stages, smem = best
    n_tiles = -(-p // (row_bytes // itemsize))
    lanes = max(1, min(n_tiles, sms * bps // row_blocks))
    return (itemsize, rows_per_block, row_blocks, groups, chunk, chunks,
            stages, w_resident, lanes * row_blocks, smem, vecs, bps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_src", SIZES)
@pytest.mark.parametrize("n_rows", SIZES)
def test_one_experiment_is_the_plan_before_the_experiment_axis(n_rows, n_src,
                                                               dtype):
    """``experiments=1`` gives every field of the earlier plan on every
    shape of this file's cases (the FFN, VGG-16 and ragged planes, and
    one SM up to the H100's 132), so no single-experiment launch moves."""
    for p in (14_982_479, 118_282, 200_003, 5000, 1001, 515, 37, 1):
        for sms in (H100_SMS, 8, 1):
            pl = tk.mix_plan(n_rows, n_src, p, dtype, sms)
            assert pl.experiments == 1
            assert dataclasses.astuple(pl)[:-1] == \
                _plan_before_the_experiment_axis(n_rows, n_src, p, dtype,
                                                 sms)
            assert pl == tk.mix_plan(n_rows, n_src, p, dtype, sms,
                                     experiments=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("experiments", [2, 3, 6, 200])
def test_experiments_share_the_resident_blocks(experiments, dtype):
    """E experiments divide the SMs' resident blocks: each gets at least
    one lane a row block, E × the grid stays within the resident blocks
    (or E row blocks), and every other field is the single plan's."""
    for n, p in ((33, 118_282), (33, 14_982_479), (70, 515), (5, 37)):
        one = tk.mix_plan(n, n, p, dtype, H100_SMS)
        pl = tk.mix_plan(n, n, p, dtype, H100_SMS, experiments=experiments)
        assert pl.experiments == experiments
        assert pl.grid % pl.row_blocks == 0 and pl.grid >= pl.row_blocks
        assert pl.grid * experiments <= max(
            pl.row_blocks * experiments, H100_SMS * pl.blocks_per_sm)
        assert dataclasses.replace(pl, grid=one.grid, experiments=1) == one
        assert list(pl.c_args())[-1] == experiments
    with pytest.raises(ValueError, match="experiments"):
        tk.mix_plan(33, 33, 10, torch.float32, H100_SMS, experiments=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("experiments", [2, 6])
def test_batched_schedule_computes_each_experiments_mix(experiments, dtype):
    """The kernel's walk with the batched plan (the y index an experiment,
    the x grid of that plan) writes each experiment's ``W_e @ X_e``; an
    output element's sum runs over the same source chunks in the same
    order as the single plan's, whatever E."""
    n, p = 33, 5000
    rng = np.random.default_rng(experiments)
    pl = tk.mix_plan(n, n, p, dtype, 4, experiments=experiments)
    one = tk.mix_plan(n, n, p, dtype, 4)
    assert (pl.chunk, pl.chunks) == (one.chunk, one.chunks)
    for _ in range(experiments):
        w = rng.random((n, n))
        x = rng.normal(size=(n, p))
        got, max_read = _walk(pl, w, x, p)
        assert not np.isnan(got).any() and max_read == p - 1
        np.testing.assert_allclose(got, w @ x, rtol=1e-12, atol=1e-12)
