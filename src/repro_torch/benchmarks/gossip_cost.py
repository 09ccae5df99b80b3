"""The mix-cost study on the card (port of ``benchmarks/gossip_cost.py``).

Three studies, each returning its record with the reference's keys
(``BENCH_mix/v1``) and writing a file only when given ``out_path``:

* :func:`run` — the gossip *schedule*: dense all-gather against the
  circulant ring-offset schedule, with and without a reverse
  Cuthill–McKee relabel of the nodes (:func:`relabel_for_ring`), which
  cuts the offsets a schedule needs.  Per topology: the offset counts,
  the modeled bytes a node receives on a ring of devices, and the time of
  the two single-card mixes (``mix_dense``, ``mix_sparse_host``).
* :func:`run_mix` — one Eq. (2) mix through every backend: the einsum,
  the legacy per-row K-way MAC (``mix_dense_rows``, the
  ``gossip_mix`` kernel, one launch a leaf), the fused plane in f32 and
  bf16 (``gossip_plane``), the edge list (``gossip_edges``) and the
  circulant schedule (``mix_sparse``), each first held to ``mix_dense``
  (f32 to 1e-6, the bf16 plane to 2e-2), then timed, beside the
  reference's modeled device-memory bytes.  On the reference's ragged
  tree (n = 8) or on the FFN and VGG-16 trees at n = 33.
* :func:`run_scaling` — the fused plane against the edge list on ring
  and BA graphs at n ∈ {64, 256, 1024}, at the FFN's width.

Times are medians of CUDA-event pairs on the card (host-clock medians
when ``device="cpu"``, where the kernel wrappers run their plain
versions, as the tests do).  Every matrix comes from the float64 host
path (``core.strategies.mixing_matrix``), cast to f32, as the
reference's study builds it.

    PYTHONPATH=src python3 -m repro_torch.benchmarks.gossip_cost --mix-only
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tree_util
from repro_torch.core.decentralized import sparse_schedule
from repro_torch.core.mixing import (
    circulant_decomposition,
    edge_weights,
    mix_dense,
    mix_sparse,
    mix_sparse_host,
    mixing_collective_bytes,
    sparse_offsets,
)
from repro_torch.core.plane import PlaneLayout, aligned_plane
from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
from repro_torch.core.topology import (
    Topology,
    barabasi_albert,
    padded_neighbor_tables,
    ring,
    watts_strogatz,
)
from repro_torch.kernels import gossip_mix as gm

__all__ = ["csv_row", "relabel_for_ring", "permuted_matrix", "model_params",
           "run", "run_mix", "run_scaling", "FFN_P"]

FFN_P = 118_282       # the paper's FFN, parameters a node
_DEGREE = AggregationStrategy("degree", tau=0.1)


def csv_row(name: str, secs: float, derived: str) -> str:
    """The reference's ``name,us_per_call,derived`` CSV convention."""
    return f"{name},{secs * 1e6:.0f},{derived}"


def relabel_for_ring(topo: Topology) -> np.ndarray:
    """Reverse Cuthill–McKee node order (the new order of the old
    indices): it narrows the adjacency's band, so the nodes laid out on a
    ring of devices need fewer and shorter circulant offsets."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(topo.adjacency)))


def permuted_matrix(c: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return c[np.ix_(perm, perm)]


def _coeffs(topo: Topology, device) -> torch.Tensor:
    """The study's matrix: ``degree`` at τ = 0.1 on the host in float64,
    cast to f32 (the reference's ``jnp.asarray`` with x64 off)."""
    return torch.as_tensor(mixing_matrix(topo, _DEGREE), dtype=torch.float32,
                           device=device)


def _median_s(fns: Dict[str, Callable[[], object]], reps: int,
              device: torch.device) -> Dict[str, float]:
    """Median seconds of one call of each function, the repetitions
    interleaved across the functions (a slow spell hits all of them): CUDA
    events on the card, the host clock on the CPU.  Each is called once
    first to warm up."""
    for f in fns.values():
        f()
    times: Dict[str, list] = {k: [] for k in fns}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        pairs: Dict[str, list] = {k: [] for k in fns}
        for _ in range(reps):
            for k, f in fns.items():
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                f()
                b.record()
                pairs[k].append((a, b))
        torch.cuda.synchronize(device)
        for k, ps in pairs.items():
            times[k] = [a.elapsed_time(b) / 1e3 for a, b in ps]
    else:
        for _ in range(reps):
            for k, f in fns.items():
                t0 = time.perf_counter()
                f()
                times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def _assert_close(got, want, tol: float, name: str) -> None:
    """Every leaf within ``tol + tol·|want|`` (the reference's
    ``assert_allclose(rtol=tol, atol=tol)``), compared where it lies."""
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(want)):
        a, b = a.float(), b.float()
        ok = bool(((a - b).abs() <= tol + tol * b.abs()).all())
        if not ok:
            err = float((a - b).abs().max())
            raise AssertionError(f"{name}: max abs error {err} against "
                                 f"mix_dense, beyond {tol}")


def _write(record, out_path: Optional[str]) -> None:
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1, default=float)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


# ----------------------------------------------------------------------
# the schedule study
# ----------------------------------------------------------------------
def _two_leaves(n_nodes: int, n_params: int, device, gen) -> dict:
    per = n_params // 2
    return {k: torch.randn((n_nodes, per // 1024, 1024), generator=gen,
                           device=device) for k in ("a", "b")}


def run(log=print, n_params: int = 8_000_000, reps: int = 3, device=None,
        seed: int = 0) -> List[dict]:
    """Offsets, modeled ring bytes and single-card mix times of the dense
    and circulant schedules on ring16, BA(16, 1), BA(16, 2) and
    WS(16, 4, 0.5), at ``n_params`` floats a node (two leaves)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, topo in [
        ("ring16", ring(16)),
        ("ba16_p1", barabasi_albert(16, 1, seed=0)),
        ("ba16_p2", barabasi_albert(16, 2, seed=0)),
        ("ws16", watts_strogatz(16, 4, 0.5, seed=0)),
    ]:
        c = mixing_matrix(topo, _DEGREE)
        sched = circulant_decomposition(c)
        perm = relabel_for_ring(topo)
        sched_rcm = circulant_decomposition(permuted_matrix(c, perm))
        nz = lambda s: sum(1 for o in s.offsets if o != 0)
        pbytes = n_params * 4
        model = mixing_collective_bytes(topo.n_nodes, pbytes, sched)
        model_rcm = mixing_collective_bytes(topo.n_nodes, pbytes, sched_rcm)

        params = _two_leaves(topo.n_nodes, n_params, dev, gen)
        cj = torch.as_tensor(c, dtype=torch.float32, device=dev)
        _assert_close(mix_sparse_host(params, sched), mix_dense(params, cj),
                      1e-6, f"mix_sparse_host {name}")
        t = _median_s({"dense": lambda: mix_dense(params, cj),
                       "sparse": lambda: mix_sparse_host(params, sched)},
                      reps, dev)
        td, ts = t["dense"], t["sparse"]
        del params
        row = dict(
            topology=name, offsets_dense=topo.n_nodes - 1,
            offsets_sparse=nz(sched), offsets_sparse_rcm=nz(sched_rcm),
            ici_bytes_dense=model["dense_bytes_per_node"],
            ici_bytes_sparse=model["sparse_bytes_per_node"],
            ici_bytes_sparse_rcm=model_rcm["sparse_bytes_per_node"],
            wall_dense_s=td, wall_sparse_s=ts,
        )
        rows.append(row)
        log(csv_row(
            f"gossip_cost/{name}", td,
            f"offsets={row['offsets_sparse']}(rcm {row['offsets_sparse_rcm']})"
            f"/{row['offsets_dense']};"
            f"bytes_sparse/dense="
            f"{row['ici_bytes_sparse'] / row['ici_bytes_dense']:.2f};"
            f"wall_sparse/dense={ts / td:.2f}"))
    return rows


# ----------------------------------------------------------------------
# the mix-kernel study
# ----------------------------------------------------------------------
def _ragged_params(n_nodes: int, n_params: int, device, gen) -> dict:
    """The reference's deliberately ragged tree (uneven leaf sizes, a
    matrix off the tile sizes, a 129-wide bias, one scalar a node),
    ≈ ``n_params`` floats a node."""
    big = max(n_params * 3 // 5 // 128, 1)
    mid = max(n_params // 4 // 96, 1)
    shapes = {"w_big": (n_nodes, big, 128), "w_mid": (n_nodes, mid, 96),
              "bias": (n_nodes, 129), "scale": (n_nodes,)}
    return {k: torch.randn(s, generator=gen, device=device)
            for k, s in shapes.items()}


def model_params(model: str, n_nodes: int, device, gen) -> dict:
    """A stacked tree with the leaf shapes of the port's ``ffn`` or
    ``vgg16`` (35 leaves, 5 of them one-value pool markers), filled with
    normal draws on ``device``: distinct rows a node."""
    from repro_torch.models.paper_models import ffn_init, vgg_init

    init = {"ffn": ffn_init, "vgg16": vgg_init}[model]
    one = init(torch.Generator().manual_seed(0))   # for its shapes
    return tree_util.tree_map(
        lambda x: torch.randn((n_nodes,) + tuple(x.shape), generator=gen,
                              device=device), one)


def run_mix(log=print, n_nodes: int = 8, n_params: int = 48_000,
            bt: int = 1024, reps: int = 5, smoke: bool = False,
            out_path: Optional[str] = None, device=None,
            model: Optional[str] = None, seed: int = 0) -> Dict[str, dict]:
    """One Eq. (2) mix through every backend: held to ``mix_dense``, then
    timed, beside its modeled bytes.  ``model=None`` mixes the
    reference's ragged tree (``smoke`` cuts it to 12,000 floats a node);
    ``"ffn"`` or ``"vgg16"`` the model's tree at ``n_nodes``.  The matrix
    is ``degree`` on BA(n_nodes, 2, seed 0).  ``launches_per_mix`` is
    counted on the card (0 on the CPU, where no kernel runs)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if model is None:
        if smoke:
            n_params = min(n_params, 12_000)
        params = _ragged_params(n_nodes, n_params, dev, gen)
    else:
        params = model_params(model, n_nodes, dev, gen)
    layout = PlaneLayout.from_tree(params)
    p_floats = layout.n_params
    n_leaves = len(layout.slots)
    topo = barabasi_albert(n_nodes, 2, seed=0)
    coeffs = _coeffs(topo, dev)
    support = topo.adjacency + np.eye(n_nodes)
    nbr_idx, nbr_mask = padded_neighbor_tables(support)
    dmax = int(nbr_idx.shape[1])
    idx = torch.as_tensor(nbr_idx, device=dev)
    msk = torch.as_tensor(nbr_mask, device=dev)
    offsets = sparse_offsets(support)
    bf16 = lambda p: tree_util.tree_map(lambda x: x.to(torch.bfloat16), p)
    f32 = lambda p: tree_util.tree_map(lambda x: x.to(torch.float32), p)

    impls = {
        "einsum": dict(
            fn=mix_dense, counter=None, tol=1e-6,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "einsum", n_nodes, p_floats, n_leaves=n_leaves),
            kernel_programs_per_mix=n_leaves),
        "pallas_rows": dict(
            fn=gm.mix_dense_rows, counter=gm.gossip_mix, tol=1e-6,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "pallas_rows", n_nodes, p_floats, n_leaves=n_leaves),
            kernel_programs_per_mix=n_leaves * n_nodes),
        "pallas_plane": dict(
            fn=gm.mix_plane, counter=gm.gossip_plane, tol=1e-6,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "pallas_plane", n_nodes, p_floats, bt=bt),
            modeled_hbm_bytes_e2e=gm.mix_modeled_hbm_bytes(
                "pallas_plane_e2e", n_nodes, p_floats, bt=bt),
            kernel_programs_per_mix=1),
        "pallas_plane_bf16": dict(
            # the reference packs a bf16 plane and unpacks to f32 leaves
            fn=lambda p, c: f32(gm.mix_plane(bf16(p), c)),
            counter=gm.gossip_plane, tol=2e-2,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "pallas_plane", n_nodes, p_floats, itemsize=2, bt=bt),
            kernel_programs_per_mix=1),
        "edges": dict(
            fn=lambda p, c: gm.mix_edges_kernel(p, c, idx, msk),
            counter=gm.gossip_edges, tol=1e-6,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "edges", n_nodes, p_floats, bt=bt, max_neighbors=dmax),
            kernel_programs_per_mix=1, max_neighbors=dmax),
        "sparse": dict(
            # the circulant schedule itself, whatever the trainer's
            # fallback would decide (recorded as sparse_fallback)
            fn=lambda p, c: mix_sparse(p, c, offsets), counter=None,
            tol=1e-6,
            modeled_hbm_bytes=gm.mix_modeled_hbm_bytes(
                "sparse", n_nodes, p_floats, n_offsets=len(offsets)),
            kernel_programs_per_mix=0, n_offsets=len(offsets),
            sparse_fallback=sparse_schedule(support)[0] is None),
    }
    # equivalence gate before timing, and the launches of one mix
    ref = mix_dense(params, coeffs)
    fns = {}
    for name, rec in impls.items():
        fn, counter, tol = rec.pop("fn"), rec.pop("counter"), rec.pop("tol")
        before = counter.launches if counter is not None else 0
        _assert_close(fn(params, coeffs), ref, tol, name)
        rec["launches_per_mix"] = (counter.launches - before
                                   if counter is not None else 0)
        fns[name] = (lambda f: lambda: f(params, coeffs))(fn)
    del ref
    walls = _median_s(fns, reps, dev)
    for name, rec in impls.items():
        rec["wall_s"] = walls[name]
        log(csv_row(f"mix/{name}", rec["wall_s"],
                    f"modeled_hbm_mb={rec['modeled_hbm_bytes'] / 1e6:.2f};"
                    f"programs={rec['kernel_programs_per_mix']};"
                    f"launches={rec['launches_per_mix']}"))

    rows, plane = impls["pallas_rows"], impls["pallas_plane"]
    record = {
        "schema": "BENCH_mix/v1",
        "config": {
            "backend": dev.type,
            # on the CPU the kernel wrappers run their plain versions
            "pallas_interpret": dev.type == "cpu",
            "device_name": _device_name(dev),
            "model": model or "ragged",
            "n_nodes": n_nodes,
            "param_floats_per_node": p_floats,
            "n_leaves": n_leaves,
            "leaf_shapes": [list(s.shape) for s in layout.slots],
            "dtype": "float32",
            "bt": bt,
            "reps": reps,
            "smoke": smoke,
        },
        "impls": impls,
        "fused_vs_rows": {
            "wall_speedup": rows["wall_s"] / plane["wall_s"],
            "hbm_bytes_ratio": (rows["modeled_hbm_bytes"]
                                / plane["modeled_hbm_bytes"]),
            "dominates": bool(
                plane["wall_s"] < rows["wall_s"]
                and plane["modeled_hbm_bytes"] < rows["modeled_hbm_bytes"]),
        },
        "fused_vs_einsum": {
            "wall_ratio": impls["einsum"]["wall_s"] / plane["wall_s"],
            "hbm_bytes_ratio": (impls["einsum"]["modeled_hbm_bytes"]
                                / plane["modeled_hbm_bytes"]),
        },
    }
    _write(record, out_path)
    log(csv_row(
        "mix/fused_vs_rows", plane["wall_s"],
        f"speedup={record['fused_vs_rows']['wall_speedup']:.1f}x;"
        f"bytes_ratio={record['fused_vs_rows']['hbm_bytes_ratio']:.1f}x;"
        f"dominates={record['fused_vs_rows']['dominates']}"))
    return record


# ----------------------------------------------------------------------
# the n-scaling study: fused plane against the edge list
# ----------------------------------------------------------------------
def run_scaling(log=print, n_params: int = FFN_P, bt: int = 1024,
                reps: int = 3, smoke: bool = False,
                out_path: Optional[str] = None, device=None,
                seed: int = 0) -> List[dict]:
    """One mix of an ``(n, n_params)`` f32 plane on ring(n) and
    BA(n, 2) at n ∈ {64, 256, 1024} ({64, 256} with ``smoke``): the fused
    plane (O(n²) coefficients) against the edge list (O(n·dmax)), each
    first held to ``C @ plane`` to 1e-6."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ns = (64, 256) if smoke else (64, 256, 1024)
    rows: List[dict] = []
    for n in ns:
        for tname, topo in (("ring", ring(n)),
                            ("ba_p2", barabasi_albert(n, 2, seed=0))):
            c = _coeffs(topo, dev)
            nbr_idx, nbr_mask = padded_neighbor_tables(
                topo.adjacency + np.eye(n))
            dmax = int(nbr_idx.shape[1])
            idx = torch.as_tensor(nbr_idx, device=dev)
            w = edge_weights(c, idx, torch.as_tensor(nbr_mask, device=dev))
            plane = aligned_plane(n, n_params, torch.float32, dev)
            plane.copy_(torch.randn((n, n_params), generator=gen,
                                    device=dev))
            oracle = c @ plane
            for name, fn in (("dense", gm.gossip_plane(plane, c)),
                             ("edges", gm.gossip_edges(plane, w, idx))):
                _assert_close(fn, oracle, 1e-6, f"{name} {tname}{n}")
            del oracle
            walls = _median_s(
                {"dense": lambda: gm.gossip_plane(plane, c),
                 "sparse": lambda: gm.gossip_edges(plane, w, idx)}, reps, dev)
            db = gm.mix_modeled_hbm_bytes("pallas_plane", n, n_params, bt=bt)
            eb = gm.mix_modeled_hbm_bytes("edges", n, n_params, bt=bt,
                                          max_neighbors=dmax)
            row = dict(
                topology=f"{tname}{n}", n_nodes=n, max_degree=dmax,
                dense=dict(impl="pallas_plane", wall_s=walls["dense"],
                           modeled_hbm_bytes=db),
                sparse=dict(impl="edges", wall_s=walls["sparse"],
                            modeled_hbm_bytes=eb),
                sparse_vs_dense_bytes_ratio=db / eb,
            )
            rows.append(row)
            del plane
            log(csv_row(
                f"mix_scaling/{row['topology']}", row["sparse"]["wall_s"],
                f"dmax={dmax};bytes_dense/edges="
                f"{row['sparse_vs_dense_bytes_ratio']:.2f};"
                f"wall_dense/edges="
                f"{row['dense']['wall_s'] / row['sparse']['wall_s']:.2f}"))
    _write({"schema": "BENCH_mix/v1", "scaling": {
        "config": {"backend": dev.type, "pallas_interpret": dev.type == "cpu",
                   "device_name": _device_name(dev),
                   "param_floats_per_node": n_params, "bt": bt,
                   "reps": reps, "smoke": smoke},
        "series": rows}}, out_path)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mix-only", action="store_true",
                    help="only the mix-kernel study (run_mix)")
    ap.add_argument("--scaling", action="store_true",
                    help="only the n-scaling study (run_scaling)")
    ap.add_argument("--model", choices=("ragged", "ffn", "vgg16"),
                    default="ragged", help="run_mix's tree (ffn and vgg16 "
                    "at n = 33)")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, as the reference's --smoke")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "versions")
    ap.add_argument("--out", default=None,
                    help="write the last study's record to this JSON file")
    args = ap.parse_args(argv)
    model = None if args.model == "ragged" else args.model
    n_nodes = 8 if model is None else 33
    if args.mix_only or not args.scaling:
        rec = run_mix(n_nodes=n_nodes, smoke=args.smoke, device=args.device,
                      model=model, out_path=args.out)
        print(json.dumps(rec, default=float))
    if args.scaling or not args.mix_only:
        rows = run_scaling(smoke=args.smoke, device=args.device,
                           n_params=4096 if args.smoke else FFN_P,
                           out_path=args.out)
        print(json.dumps(rows, default=float))
    if not (args.mix_only or args.scaling):
        print(json.dumps(run(device=args.device,
                             n_params=80_000 if args.smoke else 8_000_000),
                         default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
