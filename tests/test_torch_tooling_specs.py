"""The port's dry-run inputs (``repro_torch.launch.specs``) and memory
dry-run (``repro_torch.launch.dryrun``) against the reference's, on the
CPU.

* ``LONG_CTX_OK``/``LONG_CTX_SKIP`` and ``applicable_shapes`` equal the
  reference's (34 pairs);
* for every pair and both meshes, ``input_specs``' abstract trees (shapes
  and dtypes, the port's fake tensors against the reference's
  ``ShapeDtypeStruct``s), partition specs, kind, node count and meta equal
  the reference's, entry for entry (exact);
* for every pair and both meshes, the dry-run's resident bytes a device
  equal what the reference's ``input_specs`` gives: per leaf, the element
  count over the sharded axes' sizes, times the item size, summed by kind
  (exact).  Nothing is compiled: the reference's trees come from
  ``jax.eval_shape``, each distinct init traced once (its two pure
  builders memoized for the module);
* the dry-run's verdict on one H100: internvl2-1b's ``make_train_step``
  at microbatch 1, two sequences of 512 a node (``chip_smoke.py`` phase
  17's step) fits at n = 2 and not at n = 4, as the card showed (58.09 GB
  peak at n = 2, out of memory at n = 4);
* :class:`LiveBytes` on real CPU tensors: the peak of a known sequence of
  allocations, a kernel region's temporaries left out; the CLI.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape, ParallelConfig
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import specs as tspecs

torch.set_num_threads(2)

ARCHS = sorted(registry.ARCHS)
PAIRS = [(arch, s.name) for arch in ARCHS
         for s in tspecs.applicable_shapes(arch)]


def test_long_context_tables_and_applicable_shapes():
    import repro.launch.specs as js

    assert tspecs.LONG_CTX_OK == js.LONG_CTX_OK
    assert tspecs.LONG_CTX_SKIP == js.LONG_CTX_SKIP
    for arch in ARCHS:
        assert [s.name for s in tspecs.applicable_shapes(arch)] == \
            [s.name for s in js.applicable_shapes(arch)], arch
    assert len(PAIRS) == 34


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's ``input_specs`` for a (arch, shape, multi_pod),
    with its params and AdamW builders memoized by (config, node count):
    both are pure functions of those, so the trees are the same."""
    import jax
    import repro.launch.specs as js

    params = functools.lru_cache(maxsize=None)(js._abstract_params)
    real_opt = js._abstract_opt

    @functools.lru_cache(maxsize=None)
    def opt(cfg, n):
        return real_opt(cfg, None, params(cfg, n))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "_abstract_params", params)
        mp.setattr(js, "_abstract_opt", lambda cfg, pcfg, p: opt(
            cfg, jax.tree.leaves(p)[0].shape[0]))
        cache = {}

        def get(arch, shape, multi_pod):
            key = (arch, shape, multi_pod)
            if key not in cache:
                cache[key] = js.input_specs(arch, shape, multi_pod=multi_pod)
            return cache[key]

        yield get


def _ref_leaves(tree, is_spec=False):
    """``{dotted path: leaf}`` of a reference tree (the spec trees with
    their ``PartitionSpec``s as leaves)."""
    import jax
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, P)) if is_spec else None)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): leaf for path, leaf in flat}


def _port_leaves(tree):
    return {".".join(map(str, path)): leaf
            for path, leaf in tree_util.leaves_with_paths(tree)}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_equal_the_reference(arch, shape, reference_specs):
    for multi_pod in (False, True):
        want = reference_specs(arch, shape, multi_pod)
        got = tspecs.input_specs(arch, shape, multi_pod=multi_pod)
        assert (got.kind, got.n_global_nodes, got.meta) == \
            (want.kind, want.n_global_nodes, want.meta)
        ra, pa = _ref_leaves(want.abstract_args), _port_leaves(
            got.abstract_args)
        assert sorted(pa) == sorted(ra)
        for k in ra:
            assert (tuple(pa[k].shape), _dtype(pa[k])) == \
                (tuple(ra[k].shape), _dtype(ra[k])), (multi_pod, k)
        for w, g in ((want.in_specs, got.in_specs),
                     (want.out_specs, got.out_specs)):
            rs, ps = _ref_leaves(w, is_spec=True), _port_leaves(g)
            assert {k: tuple(v) for k, v in ps.items()} == \
                {k: tuple(v) for k, v in rs.items()}, multi_pod


def _ref_resident(spec, sizes) -> dict:
    """One device's bytes by kind from the reference's abstract args and
    partition specs: per leaf, the element count over the product of the
    sizes of the axes that shard it, times the item size."""
    names = {"train": ("params", "optimizer", "batch", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "batch", "cache")}[spec.kind]
    out = {}
    for name, args, specs in zip(names, spec.abstract_args, spec.in_specs):
        leaves, spec_leaves = _ref_leaves(args), _ref_leaves(specs, True)
        total = 0.0
        for path, leaf in leaves.items():
            # a spec stands for its leaf, or for a whole subtree (P())
            entry = spec_leaves.get(path, spec_leaves.get(""))
            if entry is None:
                entry = next(v for k, v in spec_leaves.items()
                             if path.startswith(k + "."))
            split = 1
            for dim in tuple(entry):
                for axis in (dim if isinstance(dim, tuple) else (dim,)):
                    split *= sizes.get(axis, 1) if axis else 1
            total += math.prod(leaf.shape) / split * leaf.dtype.itemsize
        out[name] = out.get(name, 0.0) + total
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_resident_bytes_equal_the_reference(arch, shape, reference_specs):
    pcfg = registry.get_parallel(arch)
    for multi_pod in (False, True):
        sizes = tdry.mesh_sizes(None, multi_pod, pcfg)
        assert sizes == {"pod": 2 if multi_pod else 1,
                         "node": pcfg.n_nodes, "fsdp": pcfg.fsdp,
                         "model": pcfg.tp_degree}
        want = _ref_resident(reference_specs(arch, shape, multi_pod), sizes)
        _, got = tdry.resident_per_device(
            tspecs.input_specs(arch, shape, multi_pod=multi_pod), sizes)
        assert got == want, multi_pod


def test_one_device_holds_every_byte():
    """On :data:`ONE_DEVICE` the resident bytes are the whole trees'."""
    spec = tspecs.input_specs("stablelm-1.6b", "decode_32k")
    _, got = tdry.resident_per_device(spec, tdry.mesh_sizes(
        tdry.ONE_DEVICE, False, None))
    whole = [sum(x.numel() * x.element_size()
                 for x in tree_util.leaves(t)) for t in spec.abstract_args]
    assert got == {"params": whole[0], "batch": whole[1],
                   "cache": whole[2], "total": sum(whole)}


def test_dry_run_fits_internvl2_train_step_at_2_nodes_not_4():
    """Phase 17's step (n distinct nodes, microbatch 1, 2 × 512 tokens a
    node, AdamW behind the nonfinite guard, einsum attention) on one
    H100: fits at n = 2, not at n = 4 (the card: 58.09 GB peak at n = 2,
    out of memory at n = 4)."""
    res = {}
    for n in (2, 4):
        res[n] = tdry.dry_run_pair(
            "internvl2-1b", InputShape("train_512", 512, 2 * n, "train"),
            pcfg=ParallelConfig(n_nodes=n, microbatch=1),
            mesh_shape=tdry.ONE_DEVICE, skip_nonfinite=True)
    assert res[2]["fits_hbm"] and not res[4]["fits_hbm"]
    peak2 = res[2]["memory"]["peak_per_device"]
    assert res[2]["memory"]["resident_per_device"]["total"] < peak2 < 80e9
    assert res[4]["memory"]["peak_per_device"] > 80e9
    for r in res.values():
        assert r["n_chips"] == 1 and r["flops_per_chip"] > 0
        # eager FLOPs count every layer: the order of 6·N·D (N counts
        # the embedding, which is a gather, not a product)
        assert 0.5 < r["flops_per_chip"] / r["model_flops"] < 2


def test_live_bytes_counts_a_cpu_run():
    """Peak and live bytes of a known sequence of allocations on real CPU
    tensors; a view adds nothing; a kernel region's temporaries do not
    raise the peak, its output does."""
    from repro_torch.analysis.walker import region

    live = tdry.LiveBytes()
    base = torch.zeros(250)                      # 1000 B, an input
    live.track([base])
    with live:
        a = torch.empty(1000)                    # 4000
        b = torch.empty(2000)                    # 8000
        v = b.view(2, 1000)                      # a view: no bytes
        del a
        c = torch.empty(500)                     # 2000
        assert live.live == 1000 + 8000 + 2000
        with region("gossip_plane"):
            tmp = torch.empty(10_000)            # 40000, freed inside
            out = torch.empty(100)               # 400, returned
            del tmp
    assert live.peak == 1000 + 4000 + 8000       # a and b together
    assert live.live == 1000 + 8000 + 2000 + 400
    del v, c, out


def test_dry_run_cli(tmp_path):
    code = tdry.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                      "--mesh", "one", "--out", str(tmp_path)])
    assert code == 0
    rec = __import__("json").loads(
        (tmp_path / "stablelm-1.6b__decode_32k__one.json").read_text())
    assert rec["n_chips"] == 1 and rec["modeled"] is True
    assert rec["memory"]["peak_per_device"] >= \
        rec["memory"]["resident_per_device"]["total"]
    assert np.isfinite(rec["t_memory_s"]) and rec["t_collective_s"] == 0.0
