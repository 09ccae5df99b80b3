"""The port's mix-cost study (``repro_torch.benchmarks.gossip_cost``) on
the CPU: its records carry the reference study's keys and byte models,
and its RCM relabel and offset counts equal the reference's.  The
reference study itself is not run here (its interpret-mode fan-out is
slow and it writes ``benchmarks/artifacts/BENCH_mix.json`` by default):
the byte models are compared through the two ``mix_modeled_hbm_bytes``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import gossip_cost as jcost
from repro.core.plane import PlaneLayout as JPlaneLayout
from repro.core import mixing as jmix
from repro.core import strategies as jstrat
from repro.core import topology as jtopo
from repro.kernels import gossip_mix as jgm
from repro_torch.benchmarks import gossip_cost as tcost
from repro_torch.core import topology as ttopo

torch.set_num_threads(2)

# the keys of the reference's BENCH_mix/v1 record (benchmarks/gossip_cost.py)
RECORD_KEYS = {"schema", "config", "impls", "fused_vs_rows",
               "fused_vs_einsum"}
CONFIG_KEYS = {"backend", "pallas_interpret", "n_nodes",
               "param_floats_per_node", "n_leaves", "leaf_shapes", "dtype",
               "bt", "reps", "smoke"}
IMPL_KEYS = {"modeled_hbm_bytes", "kernel_programs_per_mix", "wall_s"}
REF_IMPLS = ("einsum", "pallas_rows", "pallas_plane", "pallas_plane_bf16")


@pytest.fixture(scope="module")
def smoke_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("mix") / "BENCH_mix.json"
    rec = tcost.run_mix(log=lambda *a: None, smoke=True, reps=2,
                        device="cpu", out_path=str(out))
    return rec, out


def test_run_mix_record_has_the_reference_keys_and_bytes(smoke_record):
    """``run_mix(smoke=True)`` on the reference's ragged tree (n = 8,
    12,000 floats a node): the reference's keys, and each byte model the
    reference's function gives for the same tree."""
    rec, out = smoke_record
    assert RECORD_KEYS <= set(rec) and rec["schema"] == "BENCH_mix/v1"
    cfg = rec["config"]
    assert CONFIG_KEYS <= set(cfg)
    assert cfg["n_nodes"] == 8 and cfg["n_leaves"] == 4
    # the reference's layout of the same tree, in jax.tree order
    shapes = {"w_big": (8, 56, 128), "w_mid": (8, 31, 96), "bias": (8, 129),
              "scale": (8,)}
    jlayout = JPlaneLayout.from_tree(
        {k: jnp.zeros(v) for k, v in shapes.items()})
    assert cfg["leaf_shapes"] == [list(s.shape) for s in jlayout.slots]
    n, p, bt = 8, cfg["param_floats_per_node"], cfg["bt"]
    ba = jtopo.barabasi_albert(n, 2, seed=0)
    dmax = jtopo.padded_neighbor_tables(ba.adjacency + np.eye(n))[0].shape[1]
    assert p == 56 * 128 + 31 * 96 + 129 + 1
    impls = rec["impls"]
    assert impls["edges"]["max_neighbors"] == dmax
    assert set(REF_IMPLS) <= set(impls) and {"edges", "sparse"} <= set(impls)
    for rec_i in impls.values():
        assert IMPL_KEYS <= set(rec_i) and rec_i["wall_s"] > 0
    want = {
        "einsum": jgm.mix_modeled_hbm_bytes("einsum", n, p, n_leaves=4),
        "pallas_rows": jgm.mix_modeled_hbm_bytes("pallas_rows", n, p,
                                                 n_leaves=4),
        "pallas_plane": jgm.mix_modeled_hbm_bytes("pallas_plane", n, p,
                                                  bt=bt),
        "pallas_plane_bf16": jgm.mix_modeled_hbm_bytes(
            "pallas_plane", n, p, itemsize=2, bt=bt),
        "edges": jgm.mix_modeled_hbm_bytes("edges", n, p, bt=bt,
                                           max_neighbors=dmax),
        "sparse": jgm.mix_modeled_hbm_bytes("sparse", n, p, n_offsets=8),
    }
    for name, b in want.items():
        assert impls[name]["modeled_hbm_bytes"] == b, name
    assert impls["pallas_plane"]["modeled_hbm_bytes_e2e"] == \
        jgm.mix_modeled_hbm_bytes("pallas_plane_e2e", n, p, bt=bt)
    assert [impls[k]["kernel_programs_per_mix"] for k in REF_IMPLS] == \
        [4, 32, 1, 1]
    # on the CPU the wrappers run their plain versions: no launch counted
    assert all(r["launches_per_mix"] == 0 for r in impls.values())
    assert impls["sparse"]["n_offsets"] == 8
    assert impls["sparse"]["sparse_fallback"] is False
    assert rec["fused_vs_rows"]["hbm_bytes_ratio"] > 1.0
    assert out.is_file()


def test_run_mix_on_a_model_tree():
    """``model="ffn"`` mixes the FFN's six leaves (N = 10 among them) at
    n = 33, where BA(33, 2)'s support needs all 33 offsets: the trainer's
    schedule would fall back."""
    rec = tcost.run_mix(log=lambda *a: None, n_nodes=33, reps=1,
                        device="cpu", model="ffn")
    assert rec["config"]["n_leaves"] == 6
    assert rec["config"]["param_floats_per_node"] == tcost.FFN_P
    assert rec["impls"]["sparse"]["n_offsets"] == 33
    assert rec["impls"]["sparse"]["sparse_fallback"] is True


@pytest.mark.parametrize("name,make", [
    ("ring16", lambda m: m.ring(16)),
    ("ba16_p1", lambda m: m.barabasi_albert(16, 1, seed=0)),
    ("ba16_p2", lambda m: m.barabasi_albert(16, 2, seed=0)),
    ("ws16", lambda m: m.watts_strogatz(16, 4, 0.5, seed=0)),
    ("ba33_p2", lambda m: m.barabasi_albert(33, 2, seed=0))])
def test_relabel_for_ring_equals_reference(name, make):
    """The RCM permutation, and the circulant offsets of the permuted
    ``degree`` matrix, equal the reference's."""
    jt, tt = make(jtopo), make(ttopo)
    perm = tcost.relabel_for_ring(tt)
    assert np.array_equal(perm, jcost.relabel_for_ring(jt))
    c = jstrat.mixing_matrix(jt, jstrat.AggregationStrategy("degree",
                                                            tau=0.1))
    got = tcost.permuted_matrix(c, perm)
    want = jcost.permuted_matrix(c, perm)
    assert np.array_equal(got, want)
    from repro_torch.core.mixing import circulant_decomposition

    assert circulant_decomposition(got).offsets == \
        jmix.circulant_decomposition(want).offsets


def test_schedule_study_rows():
    """``run`` at a small width: the reference's row keys; offsets and
    modeled ring bytes from the schedules (ring16 needs offsets 1 and
    15; RCM gives it 4)."""
    rows = tcost.run(log=lambda *a: None, n_params=8192, reps=1,
                     device="cpu")
    assert [r["topology"] for r in rows] == ["ring16", "ba16_p1", "ba16_p2",
                                             "ws16"]
    keys = {"topology", "offsets_dense", "offsets_sparse",
            "offsets_sparse_rcm", "ici_bytes_dense", "ici_bytes_sparse",
            "ici_bytes_sparse_rcm", "wall_dense_s", "wall_sparse_s"}
    for r in rows:
        assert set(r) == keys
        assert r["ici_bytes_dense"] == 15 * 8192 * 4
        assert r["ici_bytes_sparse"] == r["offsets_sparse"] * 8192 * 4
    assert (rows[0]["offsets_sparse"], rows[0]["offsets_sparse_rcm"]) == (2, 4)


def test_scaling_rows():
    rows = tcost.run_scaling(log=lambda *a: None, n_params=500, reps=1,
                             smoke=True, device="cpu")
    assert [r["topology"] for r in rows] == ["ring64", "ba_p264", "ring256",
                                             "ba_p2256"]
    for r in rows:
        n = r["n_nodes"]
        assert r["dense"]["modeled_hbm_bytes"] == jgm.mix_modeled_hbm_bytes(
            "pallas_plane", n, 500, bt=1024)
        assert r["sparse"]["modeled_hbm_bytes"] == jgm.mix_modeled_hbm_bytes(
            "edges", n, 500, bt=1024, max_neighbors=r["max_degree"])
