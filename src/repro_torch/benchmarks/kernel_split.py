"""Where the time of the RWKV-6 scan and robust-mix kernels goes, on the card.

Builds variants of a kernel source (``csrc/ssm_scan.cu`` or
``csrc/gossip_robust.cu``, this tree's or another tree's, whose entry
points it tells apart by their arguments), each with one part of the
kernel taken out by a fixed text substitution, and times each at the main
path's shapes with CUDA-event medians:

* ``rwkv_scan`` at (2, 4096, 40, 64), bf16 and f32: ``full``; ``staging``
  (the global loads, the staging and the y stores, no step loop);
  ``arithmetic`` (the step loop on what shared memory holds, no global
  loads).  With this tree's source also every column block of
  ``ssm_scan.scan_plan``, and ``tile_RxC``: the kernel with other thread
  tiles (R state rows by C columns a thread) under every column block;
* ``gossip_robust`` (trimmed mean, k = 1) at the VGG-16 and FFN f32
  planes (n = 33, BA(33, 2)): ``full``; ``no_sort`` (the insertion sort
  taken out: the table, the gathers, the sums and the stores remain);
  with this tree's source also ``no_staging`` (the tile copies taken
  out), ``two_columns`` (two columns a lane, as the median takes them)
  and every tile width of ``gossip_mix.robust_plan``.

A variant computes nothing useful: only its time is read.  A source whose
text no longer holds a substitution's target fails loudly.

    PYTHONPATH=src python3 -m repro_torch.benchmarks.kernel_split \\
        [--rwkv-source PATH] [--robust-source PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build

SPLIT_DIR = build.BUILD_DIR / "split"

# (variant, [(target text, replacement)]) for each design of each kernel
# other thread tiles of the column-block design (rows, columns a thread)
RWKV_TILES = ((8, 1), (8, 4), (4, 2), (4, 4))
RWKV_TILE_TARGETS = ("constexpr int kRows = 8;", "constexpr int kCols = 2;")
RWKV_VARIANTS = {
    "plain_entry": (   # the sequential kernel, one block per (h, b)
        ("staging", [("    for (int t = 0; t < n; ++t) {",
                      "    for (int t = 0; t < 0 * n; ++t) {")]),
        ("arithmetic", [("      if (t < S) {", "      if (t < 0 * S) {")]),
    ),
    "plan_entry": (    # column blocks, a cp.async ring, a prep pass
        ("staging", [("    compute(c, st);\n", "")]),
        ("arithmetic", [
            ("    if (c < n_chunks) issue(c, c);\n", ""),
            ("      issue(c + kStages - 1, (c + kStages - 1) % kStages);\n",
             "")]),
    ),
}
ROBUST_VARIANTS = {
    "plain_entry": (   # a block per (row, 256 columns), a serial table read
        ("no_sort", [("  for (int s = 0; s < cnt; ++s) {",
                      "  for (int s = 0; s < 0 * cnt; ++s) {")]),
    ),
    "plan_entry": (    # staged column tiles, warp units, bucketed sort
        ("no_sort", [("  for (int s = 1; s < CNT; ++s) {",
                      "  for (int s = 1; s < 0 * CNT; ++s) {")]),
        ("no_staging", [
            ("    for (int q = threadIdx.x; q < n * per_row; "
             "q += kRobustThreads) {",
             "    for (int q = threadIdx.x; q < 0 * n * per_row; "
             "q += kRobustThreads) {")]),
        ("two_columns", [("  return median && slots <= 16 ? 2 : 1;",
                          "  return slots <= 16 ? 2 : 1;")]),
    ),
}


def _compile(text: str, name: str) -> ctypes.CDLL:
    """``text`` compiled as ``build.build`` compiles a source (its
    ``csrc/`` headers on the include path), cached by content."""
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = SPLIT_DIR / key / f"lib{name}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.parent / f"{name}.cu"
        src.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
               str(out), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def _variants(text: str, table):
    """[(variant, source text)] for the design ``text`` is written in."""
    design = "plan_entry" if "const long long* plan" in text else \
        "plain_entry"
    out = [("full", text)]
    subs_of = list(table[design])
    if table is RWKV_VARIANTS and design == "plan_entry":
        subs_of += [(f"tile_{r}x{c}", [
            (RWKV_TILE_TARGETS[0], f"constexpr int kRows = {r};"),
            (RWKV_TILE_TARGETS[1], f"constexpr int kCols = {c};")])
            for r, c in RWKV_TILES]
    for variant, subs in subs_of:
        v = text
        for old, new in subs:
            if v.count(old) != 1:
                raise ValueError(f"{variant}: the source holds its target "
                                 f"{old!r} {v.count(old)} times, not once")
            v = v.replace(old, new)
        out.append((variant, v))
    return design, out


def _ms(fn, reps=15):
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def rwkv_split(source: Path):
    from repro_torch.kernels import ssm_scan

    design, variants = _variants(source.read_text(), RWKV_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, hd = 2, 4096, 40, 64
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .mul_(0.5).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(torch.rand((b, s, h, hd), generator=gen,
                                            device="cuda") * 6 - 6))
        u = torch.randn((h, hd), generator=gen, device="cuda") * 0.3
        st = torch.zeros((b, h, hd, hd), device="cuda")
        y = torch.empty_like(r)
        fin = torch.empty_like(st)
        strides = (ctypes.c_longlong * 17)(
            *(x for t in (r, k, v, w, y) for x in t.stride()[:3]), 0,
            u.stride(0))
        code = 0 if dtype == torch.float32 else 1
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = [_ptr(t) for t in (r, k, v, w, u, st, y, fin)] + [
            strides, code, b, s, h, hd]
        best = ssm_scan.scan_plan(b, h, hd, dtype, 132)

        def every(rows, cols):
            return [ssm_scan.ScanPlan(
                cb, ssm_scan._threads(hd, cb, rows, cols),
                ssm_scan._smem_bytes(hd, cb, r.element_size()), hd // cb, 0)
                for cb in ssm_scan.COL_BLOCKS
                if ssm_scan._threads(hd, cb, rows, cols)]

        for variant, text in variants:
            lib = _compile(text, "ssm_scan")
            if design == "plain_entry":
                plans = [None]
            elif variant == "full":
                plans = every(ssm_scan.ROWS_PER_THREAD,
                              ssm_scan.COLS_PER_THREAD)
            elif variant.startswith("tile_"):
                plans = every(*map(int, variant[5:].split("x")))
            else:
                plans = [best]
            for plan in plans:
                if plan is None:
                    call = lambda: lib.rwkv_scan_launch(*args, stream)
                else:
                    pa = plan.c_args()
                    call = lambda: lib.rwkv_scan_launch(*args, pa, stream)
                assert call() == 0
                rows.append({
                    "kernel": "rwkv_scan", "design": design,
                    "variant": variant, "shape": [b, s, h, hd],
                    "dtype": str(dtype)[6:],
                    "col_block": None if plan is None else plan.col_block,
                    "ms": _ms(call)})
                print(json.dumps(rows[-1]), flush=True)
    return rows


def robust_split(source: Path):
    from repro_torch.core.coeffs import program_for
    from repro_torch.core.mixing import edge_weights
    from repro_torch.core.plane import aligned_plane
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.kernels import gossip_mix as gm

    design, variants = _variants(source.read_text(), ROBUST_VARIANTS)
    n = 33
    topo = barabasi_albert(n, 2, 0)
    program, state = program_for(topo, AggregationStrategy("degree"))
    c = program.matrix(state, 0).cuda()
    nbr_idx, nbr_mask = topo.neighbor_tables()
    idx = torch.as_tensor(nbr_idx, device="cuda")
    w = edge_weights(c, idx, torch.as_tensor(nbr_mask, device="cuda"))
    dmax = idx.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, p in (("vgg16", 14_982_479), ("ffn", 118_282)):
        plane = aligned_plane(n, p, torch.float32, "cuda")
        plane.copy_(torch.randn((n, p), generator=gen, device="cuda"))
        ld = plane.stride(0)
        out = torch.empty((n, ld), device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = [_ptr(w), _ptr(idx), _ptr(plane), _ptr(out), n, dmax, p, ld,
                0, 0, 0, 1]
        best = gm.robust_plan(n, p, dmax, torch.float32)
        for variant, text in variants:
            lib = _compile(text, "gossip_robust")
            lib.gossip_robust_launch.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                + ([ctypes.POINTER(ctypes.c_longlong)]
                   if design == "plan_entry" else []) + [ctypes.c_void_p])
            plans = [None]
            if design == "plan_entry":
                plans = [best]
                if variant == "full":
                    plans = [gm.RobustPlan(
                        t, True, best.slots, -(-p // t),
                        n * t * 4 + gm.ROBUST_WARPS * best.slots * 8, 0)
                        for t in gm.ROBUST_TILES
                        if t % (32 * gm.robust_cols(best.slots,
                                                    "trimmed")) == 0]
            for plan in plans:
                if plan is None:
                    call = lambda: lib.gossip_robust_launch(*args, stream)
                else:
                    pa = plan.c_args()
                    call = lambda: lib.gossip_robust_launch(*args, pa,
                                                            stream)
                assert call() == 0
                rows.append({
                    "kernel": "gossip_robust", "design": design,
                    "variant": variant, "plane": label, "shape": [n, p],
                    "dtype": "float32", "op": "trimmed",
                    "tile_cols": None if plan is None else plan.tile_cols,
                    "ms": _ms(call)})
                print(json.dumps(rows[-1]), flush=True)
        del plane, out
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rwkv-source", type=Path,
                    default=build.CSRC / "ssm_scan.cu")
    ap.add_argument("--robust-source", type=Path,
                    default=build.CSRC / "gossip_robust.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device; this script times kernels on "
              "the card")
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {out}", flush=True)
    texts = [(text, "ssm_scan") for _, text in
             _variants(args.rwkv_source.read_text(), RWKV_VARIANTS)[1]]
    texts += [(text, "gossip_robust") for _, text in
              _variants(args.robust_source.read_text(), ROBUST_VARIANTS)[1]]
    with ThreadPoolExecutor(len(texts)) as pool:   # one nvcc a variant
        list(pool.map(lambda t: _compile(*t), texts))
    rwkv_split(args.rwkv_source)
    robust_split(args.robust_source)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
