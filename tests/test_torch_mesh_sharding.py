"""The port's meshes (``repro_torch.launch.mesh``) and sharding rules
(``repro_torch.sharding``) against the reference's, on the CPU.

* the training and production mesh shapes and axis names, and the
  ``ValueError`` cases, equal the reference's arithmetic (its mesh
  factory, ``repro.launch.mesh._mesh``, stubbed to return the shape it
  would lay out: the reference needs 256 devices for the real mesh);
* for every registry config, at full size and at smoke, ``param_specs``
  (with and without the config's ``ParallelConfig`` axis sizes),
  ``opt_specs_like`` of AdamW's state, ``cache_specs`` and
  ``batch_specs`` equal the reference's ``PartitionSpec`` entry for entry.
  The reference's trees come from ``jax.eval_shape``; the port's from its
  own inits under ``FakeTensorMode`` (no memory: deepseek-v2 at full
  size is 236 B parameters), its truncated-normal draw stubbed;
* at world 4 (gloo, spawned), a smoke tree goes through
  ``distribute_tensor`` with ``named_shardings``' placements on a (node,
  model) mesh and comes back equal through ``full_tensor()``; the sweep
  mesh's refusals.
"""
import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.launch import mesh as tmesh
from repro_torch import sharding as tsh

torch.set_num_threads(2)

ARCHS = sorted(registry.ARCHS)
N_NODES, BATCH, SEQ = 4, 2, 64


@contextlib.contextmanager
def _fake_init(monkeypatch):
    """Trees of fake tensors: shapes and dtypes, no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **k: t)
    with FakeTensorMode():
        yield


def _ref_entries(specs):
    """``{dotted path: tuple(spec)}`` of a reference spec tree."""
    import jax
    from jax.sharding import PartitionSpec as P

    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)[0]
    for path, spec in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "name",
                                                     getattr(k, "idx", k))))
                       for k in path)
        out[key] = None if spec is None else tuple(spec)
    return out


def _port_entries(specs):
    return {".".join(map(str, path)): tuple(spec)
            for path, spec in tree_util.leaves_with_paths(specs)}


def _ref_trees(cfg, n):
    """The reference's abstract stacked params, AdamW state and cache."""
    import jax

    from repro.models.transformer import init_cache, init_params
    from repro.training.optimizer import adamw

    one = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.key(0))
    stack = lambda t: jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((n,) + x.shape, x.dtype), t)
    params = stack(one)
    opt = jax.eval_shape(jax.vmap(adamw(3e-4).init), params)
    cache = stack(jax.eval_shape(lambda: init_cache(cfg, BATCH, SEQ)))
    return params, opt, cache


def _port_trees(cfg, n, monkeypatch):
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.training.optimizer import adamw

    with _fake_init(monkeypatch):
        stack = lambda t: tree_util.tree_map(
            lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape)), t)
        params = stack(init_params(torch.Generator(), cfg))
        opt = adamw(3e-4).init(params)
        cache = stack(init_cache(cfg, BATCH, SEQ, device="cpu"))
    return params, opt, cache


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, size, monkeypatch):
    import repro.configs.registry as jreg
    import repro.sharding as jsh

    get = "get_config" if size == "full" else "get_smoke_config"
    jcfg, tcfg = getattr(jreg, get)(arch), getattr(registry, get)(arch)
    jp, jo, jc = _ref_trees(jcfg, N_NODES)
    tp, to, tc = _port_trees(tcfg, N_NODES, monkeypatch)
    pcfg = registry.get_parallel(arch)
    sizes = {"model": pcfg.tp_degree, "fsdp": pcfg.fsdp}
    for kw in ({}, {"axis_sizes": sizes}, {"use_fsdp": False},
               {"node_axes": "node", "use_model": False}):
        want = jsh.param_specs(jp, **kw)
        got = tsh.param_specs(tp, **kw)
        assert _port_entries(got) == _ref_entries(want), kw
    want_p = jsh.param_specs(jp, axis_sizes=sizes)
    got_p = tsh.param_specs(tp, axis_sizes=sizes)
    want_o = jsh.opt_specs_like(jo, want_p)
    got_o = tsh.opt_specs_like(to, got_p)
    assert set(got_o) == {"mu", "nu", "step"}
    for k in ("mu", "nu"):
        assert _port_entries(got_o[k]) == _ref_entries(getattr(want_o, k))
    assert tuple(got_o["step"]) == tuple(want_o.step)
    assert _port_entries(tsh.cache_specs(tc)) == _ref_entries(
        jsh.cache_specs(jc))


def test_batch_and_optimizer_specs_equal_the_reference():
    """``batch_specs`` on train batches with and without a microbatch dim
    and a scalar; SGD states with and without momentum."""
    import jax
    import jax.numpy as jnp
    import repro.sharding as jsh
    from repro.training.optimizer import sgd as jsgd

    from repro_torch.training.optimizer import sgd

    batch = {"tokens": np.zeros((4, 2, 8, 16), np.int32),
             "labels": np.zeros((4, 8, 16), np.int32),
             "embeddings": np.zeros((4, 2, 8, 16, 32), np.float32),
             "mask": np.zeros((4, 8), np.float32), "step": np.float32(0)}
    for kw in ({}, {"data_axis": "model"}, {"node_axes": "node"}):
        assert _port_entries(tsh.batch_specs(batch, **kw)) == \
            _ref_entries(jsh.batch_specs(batch, **kw)), kw
    params = {"a": {"w": np.zeros((4, 8, 6), np.float32)},
              "dense_layers": {"mlp": {"wi": np.zeros((4, 2, 8, 6),
                                                      np.float32)}}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_util.tree_map(torch.from_numpy, params)
    for mom in (0.0, 0.9):
        want = jsh.opt_specs_like(jax.vmap(jsgd(1e-2, momentum=mom).init)(jp),
                                  jsh.param_specs(jp))
        got = tsh.opt_specs_like(sgd(1e-2, momentum=mom).init(tp),
                                 tsh.param_specs(tp))
        assert tuple(got["step"]) == tuple(want.step)
        if mom:
            assert _port_entries(got["momentum"]) == \
                _ref_entries(want.momentum)
        else:
            assert got["momentum"] is None and want.momentum is None
    with pytest.raises(TypeError, match="unknown optimizer state"):
        tsh.opt_specs_like({"inner": {}, "skipped": None}, {})


MESHES = [(16, 16, False), (16, 16, True), (64, 4, False), (8, 2, True),
          (32, 8, False), (1, 1, False)]


def test_mesh_shapes_equal_the_reference(monkeypatch):
    import repro.launch.mesh as jmesh

    monkeypatch.setattr(jmesh, "_mesh", lambda shape, axes: (tuple(shape),
                                                              tuple(axes)))
    for n, tp, multi in MESHES:
        assert tmesh.training_mesh_shape(n, tp=tp, multi_pod=multi) == \
            jmesh.make_training_mesh(n, tp=tp, multi_pod=multi)
    for multi in (False, True):
        assert tmesh.production_mesh_shape(multi_pod=multi) == \
            jmesh.make_production_mesh(multi_pod=multi)
    assert (tmesh.POD_DATA, tmesh.POD_MODEL) == (jmesh.POD_DATA,
                                                 jmesh.POD_MODEL)
    for n, tp in ((3, 16), (16, 32), (512, 1)):
        with pytest.raises(ValueError) as want:
            jmesh.make_training_mesh(n, tp=tp)
        with pytest.raises(ValueError) as got:
            tmesh.training_mesh_shape(n, tp=tp)
        assert str(got.value) == str(want.value)


def test_meshes_need_their_world():
    """Without a process group every factory raises; in a world of 1 the
    training and production meshes (256 and 512 ranks) raise, and a sweep
    mesh of 2 names ``--nproc-per-node``."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_sweep_mesh()
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_training_mesh()
    dev = tmesh.init_distributed("cpu")
    try:
        assert dev == torch.device("cpu") and dist.get_world_size() == 1
        assert tmesh.init_distributed("cpu") == dev    # kept
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            tmesh.make_training_mesh()
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="--nproc-per-node 2"):
            tmesh.make_sweep_mesh(2)
        m = tmesh.make_sweep_mesh()
        assert (m.ranks, m.index, m.axis_name) == ((0,), 0, "exp")
    finally:
        dist.destroy_process_group()


def _worker(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.transformer import init_params

        res = {}
        cfg = registry.get_smoke_config("stablelm-1.6b")
        one = init_params(torch.Generator().manual_seed(0), cfg)
        params = tree_util.tree_map(
            lambda x: torch.stack([x, x * 2, x + 1, -x]), one)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("node", "model"))
        specs = tsh.param_specs(params, axis_sizes={"node": 2, "model": 2})
        places = tsh.named_shardings(specs, mesh)
        back, local = [], []
        for path, x in tree_util.leaves_with_paths(params):
            p = places
            for k in path:   # a leaf's placements: a tuple, one a mesh dim
                p = p[k]
            d = distribute_tensor(x, mesh, list(p))
            local.append((".".join(map(str, path)),
                          tuple(d.to_local().shape)))
            back.append(torch.equal(d.full_tensor(), x))
        res["equal"], res["local"] = back, local
        try:
            tmesh.make_sweep_mesh(world + 1)
        except ValueError as e:
            res["too_many"] = str(e)
        m = tmesh.make_sweep_mesh(2)
        res["sweep"] = (m.ranks, m.index)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_named_shardings_round_trip_at_world_4(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    mp.spawn(_worker, args=(4, str(tmp_path / "store"), str(out)), nprocs=4,
             join=True)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    for r, res in enumerate(ranks):
        assert res["equal"] and all(res["equal"])
        assert res["too_many"] == ("a sweep mesh of 5 ranks in a world of "
                                   "4: launch with torchrun "
                                   "--nproc-per-node 5 (or more)")
        assert res["sweep"] == ((0, 1), r if r < 2 else -1)
    local = dict(ranks[0]["local"])
    # (node 4 → 2, L, d, heads 4 → 2 over model, hd): wq's heads split
    wq = local["dense_layers.attn.wq"]
    assert wq[0] == 2 and wq[3] == registry.get_smoke_config(
        "stablelm-1.6b").n_heads // 2


def test_node_budget_is_the_rank_share_of_the_card(monkeypatch):
    """With k local ranks on a card (``LOCAL_WORLD_SIZE`` ranks dealt
    round-robin over the cards), a rank's LocalTrain and evaluation budget
    is half of its 1/k share not yet allocated by itself (``torch.cuda``'s
    queries stubbed: an 80 GiB card, 10 GiB allocated)."""
    import types

    from repro_torch.core import decentralized as dec

    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 10 * gib)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert dec.node_budget("cuda:0") == 35 * gib
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert dec.ranks_per_card("cuda:0") == 2
    assert dec.node_budget("cuda:0") == 15 * gib
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert (dec.ranks_per_card("cuda:0"), dec.ranks_per_card("cuda:1")) \
        == (2, 1)
    assert dec.node_budget("cuda:1") == 35 * gib
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 50 * gib)
    assert dec.node_budget("cuda:0") == 0     # past its share: no room
    assert dec.node_budget("cpu") is None
