"""The port's distributed gossip (``repro_torch.core.gossip``) over gloo
on the CPU, against the reference's single-host mixes.

The reference harness's case (``tests/test_gossip_distributed.py``): n =
16 nodes of a two-leaf tree, BA(16, 2), ``unweighted`` and ``degree``,
the dense all-gather schedule and the circulant one, and ``pod_gossip``
on a 2-pod mesh; here at worlds 4 and 8 (ranks spawned with
``torch.multiprocessing.spawn`` around a ``FileStore``, one thread each),
plus ``param_spec=("fsdp",)`` on a 2 × 2 (data, fsdp) mesh.  Each rank
mixes its block of the node axis; the blocks, put back together, are
held to the reference's ``mix_dense`` and ``mix_sparse_host`` run in this
process at the harness's ``rtol=1e-5``.  Measured at both worlds: within
1.75e-7 relative of ``mix_dense`` (``gossip_mix``'s f32 sums in ascending
k against XLA's dot), and the circulant schedule 0.0 from
``mix_sparse_host`` (the same order of f32 sums), which is held exactly.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.mixing import circulant_decomposition
from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
from repro_torch.core.topology import barabasi_albert

torch.set_num_threads(2)

N = 16
RTOL = 1e-5          # the reference harness's; measured 1.75e-7
POD_COEFFS = np.array([[0.75, 0.25], [0.25, 0.75]], np.float32)


def tree():
    """The harness's stacked tree: node i holds ``arange(6) + i`` and
    ``ones(4) * i``; and a (16, 4, 3) leaf whose dim 1 the fsdp case
    splits."""
    i = np.arange(N, dtype=np.float32)
    return {"w": np.arange(6, dtype=np.float32).reshape(1, 2, 3)
            + i[:, None, None],
            "b": np.ones((N, 4), np.float32) * i[:, None],
            "f": (np.arange(N * 12, dtype=np.float32).reshape(N, 4, 3)
                  % 7.0) * 0.5}


def matrices():
    t = barabasi_albert(N, 2, seed=0)
    return {kind: mixing_matrix(t, AggregationStrategy(kind, tau=0.1))
            .astype(np.float32) for kind in ("unweighted", "degree")}


def _count_calls(module, name, counter):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        counter[name] = counter.get(name, 0) + 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)


def _worker(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.core import gossip, plane
        from repro_torch.core.gossip import make_gossip_fn, pod_gossip

        calls = {}
        _count_calls(gossip, "gossip_mix", calls)
        _count_calls(plane.PlaneLayout, "pack", calls)
        full = {k: torch.from_numpy(v) for k, v in tree().items()}
        got = {}
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        n_local = N // world
        rows = slice(rank * n_local, (rank + 1) * n_local)
        local = {k: v[rows] for k, v in full.items()}
        for kind, c in matrices().items():
            got[("dense", kind)] = make_gossip_fn(mesh, N)(
                local, torch.from_numpy(c[rows]))
            sched = circulant_decomposition(c)
            got[("sparse", kind)] = make_gossip_fn(mesh, N, schedule=sched)(
                local, torch.from_numpy(sched.weights[:, rows]))
        got["calls"] = dict(calls)
        try:   # the reference's ValueError: n not divisible by |data|
            make_gossip_fn(mesh, N + 2)
        except ValueError as e:
            got["indivisible"] = str(e)
        # two pods of world/2 ranks: rank r = pod·(world/2) + position
        pods = init_device_mesh("cpu", (2, world // 2),
                                mesh_dim_names=("pod", "data"))
        leaf = torch.arange(world * 3, dtype=torch.float32).reshape(world, 3)
        got["pod"] = pod_gossip({"x": leaf[rank:rank + 1]},
                                torch.from_numpy(POD_COEFFS),
                                pods.get_group("pod"))["x"]
        if world == 4:   # (data, fsdp) = (2, 2): dim 1 of "f" over fsdp
            m2 = init_device_mesh("cpu", (2, 2),
                                  mesh_dim_names=("data", "fsdp"))
            d, f = m2.get_coordinate()
            rows2 = slice(d * N // 2, (d + 1) * N // 2)
            shard = {"f": full["f"][rows2, 2 * f:2 * f + 2]}
            c = matrices()["degree"]
            got["fsdp_dense"] = make_gossip_fn(
                m2, N, param_spec=("fsdp",))(
                    shard, torch.from_numpy(c[rows2]))["f"]
            sched = circulant_decomposition(c)
            got["fsdp_sparse"] = make_gossip_fn(
                m2, N, schedule=sched, param_spec=("fsdp",))(
                    shard, torch.from_numpy(sched.weights[:, rows2]))["f"]
            got["fsdp_coord"] = (d, f)
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world):
    out = tmp_path / "out"
    out.mkdir()
    mp.spawn(_worker, args=(world, str(tmp_path / "store"), str(out)),
             nprocs=world, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("world", [4, 8])
def test_gossip_over_gloo_matches_the_reference(tmp_path, world):
    import jax.numpy as jnp

    from repro.core.mixing import (
        circulant_decomposition as jcirc,
        mix_dense as jmix_dense,
        mix_sparse_host as jmix_sparse,
    )

    ranks = _spawn(tmp_path, world)
    params = {k: jnp.asarray(v) for k, v in tree().items()}
    for kind, c in matrices().items():
        want = jmix_dense(params, jnp.asarray(c))
        for impl in ("dense", "sparse"):
            for k in params:
                got = np.concatenate([r[(impl, kind)][k].numpy()
                                      for r in ranks])
                _close(got, want[k])
        want_s = jmix_sparse(params, jcirc(c))
        for k in params:
            got = np.concatenate([r[("sparse", kind)][k].numpy()
                                  for r in ranks])
            assert np.array_equal(got, np.asarray(want_s[k])), (kind, k)
    # one pack and one gossip_mix launch a dense mix (2 kinds), one pack
    # a sparse mix: 4 packs and 2 launches on every rank
    for r in ranks:
        assert r["calls"] == {"pack": 4, "gossip_mix": 2}, r["calls"]
        assert r["indivisible"] == (f"n_nodes={N + 2} not divisible by "
                                    f"|data|={world}")
    leaf = np.arange(world * 3, dtype=np.float32).reshape(2, world // 2, 3)
    want = np.einsum("pq,qnd->pnd", POD_COEFFS, leaf).reshape(world, 3)
    _close(np.concatenate([r["pod"].numpy() for r in ranks]), want)
    if world == 4:
        c = matrices()["degree"]
        want = np.asarray(jmix_dense({"f": params["f"]},
                                     jnp.asarray(c))["f"])
        for key in ("fsdp_dense", "fsdp_sparse"):
            got = np.zeros_like(want)
            for r in ranks:
                d, f = r["fsdp_coord"]
                got[d * N // 2:(d + 1) * N // 2, 2 * f:2 * f + 2] = \
                    r[key].numpy()
            _close(got, want)


def test_make_gossip_fn_refuses_bad_meshes():
    """A node count the axis does not divide, an unknown axis, and a
    ``param_spec`` naming the node axis raise (a world of 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.gossip import make_gossip_fn

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        with pytest.raises(ValueError, match="no axis"):
            make_gossip_fn(mesh, N, node_axis="node")
        with pytest.raises(ValueError, match="another dim"):
            make_gossip_fn(mesh, N, param_spec=("data",))
        fn = make_gossip_fn(mesh, N)
        c = torch.from_numpy(matrices()["degree"])
        out = fn({k: torch.from_numpy(v) for k, v in tree().items()}, c)
        assert out["w"].shape == (N, 2, 3)
    finally:
        dist.destroy_process_group()
