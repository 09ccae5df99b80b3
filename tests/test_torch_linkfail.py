"""Link failure and the full coefficient program on the port against the
reference: the threefry ``(n, n)`` edge mask, the host link-failure
schedules (``core.dynamic``), ``CoeffProgram.materialize`` for every
kind × reactive × sparse × p_fail × resample, its refusals, and the
trainer with ``coeffs_fn`` against the JAX ``DecentralizedTrainer``."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coeffs as jcoeffs
from repro.core import decentralized as jdec
from repro.core import dynamic as jdyn
from repro.core import topology as jtopo
from repro.core.strategies import AggregationStrategy as JStrategy
from repro.data import backdoor as jbackdoor
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch.core import coeffs as tcoeffs
from repro_torch.core import decentralized as tdec
from repro_torch.core import dynamic as tdyn
from repro_torch.core import prng
from repro_torch.core import topology as ttopo
from repro_torch.core.strategies import AggregationStrategy as TStrategy
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)
nx = pytest.importorskip("networkx")

ALL_KINDS = sorted(["unweighted", "weighted", "random", "fl", "degree",
                    "betweenness", "metropolis", "eigenvector", "pagerank",
                    "closeness"])


def _pair(n=16, p=2, seed=1):
    return jtopo.barabasi_albert(n, p, seed), ttopo.barabasi_albert(n, p, seed)


# ----------------------------------------------------------------------
# the edge mask
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [5, 16, 33])
@pytest.mark.parametrize("p_fail", [0.0, 0.3, 0.6])
def test_edge_mask_bit_for_bit(n, p_fail):
    for seed, r in ((0, 0), (3, 7), (2 ** 31 + 1, 39)):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), r),
                                0)
        want = np.asarray(jdyn.edge_mask(jk, n, p_fail))
        got = tdyn.edge_mask(prng.fold_in(prng.fold_in(prng.key(seed), r), 0),
                             n, p_fail)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
        assert np.array_equal(got, got.T) and np.all(np.diag(got) == 1)
    if p_fail == 0.0:
        assert np.all(got == 1)


@pytest.mark.parametrize("p_fail", [0.3, 0.6])
def test_drop_edges_equals_reference(p_fail):
    jt, tt = _pair()
    for seed in range(5):
        want = jdyn.drop_edges(jt, p_fail, np.random.default_rng(seed))
        got = tdyn.drop_edges(tt, p_fail, np.random.default_rng(seed))
        assert np.array_equal(got.adjacency, want.adjacency)
        assert got.name == want.name


# ----------------------------------------------------------------------
# the host schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("reactive", [False, True])
@pytest.mark.parametrize("p_fail", [0.3, 0.6])
def test_link_failure_schedule_equals_reference(kind, reactive, p_fail):
    """float64, 4 rounds of BA(16, 2).  Measured: equal bit for bit for
    every kind but eigenvector (LAPACK eigh against ARPACK, 3e-15 in the
    scores).  Pinned: 1e-12.  Reactive eigenvector raises in both where a
    round's survivor is disconnected (networkx's AmbiguousSolution)."""
    jt, tt = _pair()
    counts = np.random.default_rng(0).integers(5, 50, 16)
    strat = dict(kind=kind, tau=0.1, seed=2)
    args = (4, p_fail)
    kw = dict(data_counts=counts, reactive=reactive)
    try:
        want = jdyn.link_failure_schedule(jt, JStrategy(**strat), *args, **kw)
    except nx.AmbiguousSolution:
        assert kind == "eigenvector" and reactive
        with pytest.raises(ttopo.AmbiguousSolution):
            tdyn.link_failure_schedule(tt, TStrategy(**strat), *args, **kw)
        return
    got = tdyn.link_failure_schedule(tt, TStrategy(**strat), *args, **kw)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.array_equal(got > 0, want > 0)
    for r in (0, 3):
        np.testing.assert_allclose(
            tdyn.dynamic_mixing_matrix(tt, TStrategy(**strat), r, p_fail,
                                       **kw), want[r], rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# the coefficient program
# ----------------------------------------------------------------------
def _programs(kind, reactive, sparse, p_fail, resample, n=12):
    jt, tt = _pair(n, 2, 3)
    counts = np.random.default_rng(n).integers(5, 50, n)
    kw = dict(data_counts=counts, p_fail=p_fail, reactive=reactive,
              resample_random=resample, sparse=sparse,
              allow_nominal_betweenness=True)
    j = jcoeffs.program_for(jt, JStrategy(kind, seed=4), **kw)
    t = tcoeffs.program_for(tt, TStrategy(kind, seed=4), **kw)
    return j, t


# measured on BA(12, 2), 3 rounds, over every case below: on nominal
# scores (and reactive degree) at most 1.2e-7 (random; one ulp of f32 exp
# and the row sums after it), 6.0e-8 for the centralities; after 200 f32
# power steps: eigenvector 3.0e-7, pagerank 4.8e-7; reactive closeness
# 1.2e-7 (exact hop counts, the exp's ulp)
STEP_TOL = dict(rtol=2.0 ** -23, atol=1e-7)
POWER_TOL = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", tcoeffs.PROGRAM_KINDS)
@pytest.mark.parametrize("reactive,sparse", [(False, False), (True, False),
                                             (True, True), (False, True)])
@pytest.mark.parametrize("p_fail", [0.0, 0.3])
@pytest.mark.parametrize("resample", [True, False])
def test_materialize_matches_reference(kind, reactive, sparse, p_fail,
                                       resample):
    (jp, js), (tp, ts) = _programs(kind, reactive, sparse, p_fail, resample)
    assert tp == tcoeffs.CoeffProgram(**{
        f: getattr(jp, f) for f in jp.__dataclass_fields__})
    assert sorted(ts) == sorted(js)
    for k in js:
        assert np.asarray(ts[k]).dtype == np.asarray(js[k]).dtype, k
    want = jp.materialize(js, 3)
    got = tp.materialize(ts, 3)
    assert got.dtype == np.float32 and got.shape == want.shape
    # the surviving support is exact
    assert np.array_equal(got > 0, want > 0)
    power = reactive and kind in ("degree", "eigenvector", "pagerank",
                                  "closeness")
    tol = POWER_TOL if power else STEP_TOL
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)
    if kind == "random" and p_fail == 0.0:   # the scores alone change
        assert resample != np.array_equal(got[0], got[1])


def test_program_kinds_and_round_indices():
    assert tcoeffs.PROGRAM_KINDS == jcoeffs.PROGRAM_KINDS
    assert tcoeffs.PORTED_KINDS == tcoeffs.PROGRAM_KINDS
    assert tcoeffs.CENTRALITY_KINDS == jcoeffs.CENTRALITY_KINDS
    (jp, js), (tp, ts) = _programs("random", False, False, 0.3, True)
    idx = np.array([5, 39, 2])
    np.testing.assert_allclose(tp.materialize(ts, round_indices=idx),
                               jp.materialize(js, round_indices=idx),
                               **STEP_TOL)


@pytest.mark.parametrize("fn,args", [
    ("degree_centrality", ()), ("eigenvector_centrality", (200,)),
    ("pagerank_centrality", (0.85, 200)), ("closeness_centrality", ())])
def test_dense_centrality_kernels_match_reference(fn, args):
    """On surviving adjacencies, connected or not.  Measured drift after
    200 f32 steps: 6.0e-8 (eigenvector), 4.5e-8 (pagerank); degree and
    closeness are exact.  Pinned 5e-7."""
    jt, _ = _pair(16, 2, 0)
    for r in range(4):
        k = prng.fold_in(prng.fold_in(prng.key(1), r), 0)
        adj = (jt.adjacency * tdyn.edge_mask(k, 16, 0.5)).astype(np.float32)
        want = np.asarray(getattr(jcoeffs, fn)(jnp.asarray(adj), *args))
        got = getattr(tcoeffs, fn)(torch.as_tensor(adj), *args).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


@pytest.mark.parametrize("fn,args", [
    ("eigenvector_centrality_sparse", (200,)),
    ("pagerank_centrality_sparse", (0.85, 200))])
def test_sparse_centrality_kernels_match_reference(fn, args):
    jt, tt = _pair(16, 2, 0)
    idx, val = tt.neighbor_tables(include_self=False)
    x = np.random.default_rng(0).normal(size=16).astype(np.float32)
    np.testing.assert_array_equal(
        tcoeffs.sparse_matvec(torch.as_tensor(idx, dtype=torch.long),
                              torch.as_tensor(val), torch.as_tensor(x)),
        np.asarray(jcoeffs.sparse_matvec(jnp.asarray(idx), jnp.asarray(val),
                                         jnp.asarray(x))))
    val = val * (np.random.default_rng(1).random(val.shape) > 0.4)
    val = val.astype(np.float32)
    want = np.asarray(getattr(jcoeffs, fn)(jnp.asarray(idx),
                                           jnp.asarray(val), *args))
    got = getattr(tcoeffs, fn)(torch.as_tensor(idx, dtype=torch.long),
                               torch.as_tensor(val), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_validate_state_kinds_refusals():
    jt, tt = _pair(8, 2, 0)
    for mod, topo, strat in ((jcoeffs, jt, JStrategy), (tcoeffs, tt,
                                                          TStrategy)):
        prog, state = mod.program_for(topo, strat("betweenness"),
                                      reactive=True)
        with pytest.raises(ValueError, match="allow_nominal_betweenness"):
            prog.materialize(state, 1)
        prog, state = mod.program_for(topo, strat("degree"), kinds=(0, 3))
        with pytest.raises(ValueError, match="pruned"):
            prog.materialize(state, 1)
        with pytest.raises(ValueError, match="non-empty"):
            mod.CoeffProgram(n_nodes=8, kinds=(9,))
        with pytest.raises(KeyError):
            mod.program_for(topo, strat("metropolis"))
        with pytest.raises(ValueError, match="data_counts"):
            mod.program_for(topo, strat("weighted"))


def test_pruned_and_link_free_programs_are_the_same_program():
    _, tt = _pair(12, 2, 3)
    full, state = tcoeffs.program_for(tt, TStrategy("degree"), p_fail=0.0)
    pruned, _ = tcoeffs.program_for(tt, TStrategy("degree"), p_fail=0.0,
                                    kinds=(4,), link_failure=False)
    assert pruned.kinds == (4,)
    assert np.array_equal(full.materialize(state, 2),
                          pruned.materialize(state, 2))


def test_stack_states_and_state_nbytes_match_reference():
    jt, tt = _pair(12, 2, 3)
    jst = [jcoeffs.program_for(jt, JStrategy(k), sparse=True)[1]
           for k in ("degree", "random")]
    tst = [tcoeffs.program_for(tt, TStrategy(k), sparse=True)[1]
           for k in ("degree", "random")]
    jstack, tstack = jcoeffs.stack_states(jst), tcoeffs.stack_states(tst)
    assert sorted(jstack) == sorted(tstack)
    for k in jstack:
        assert np.array_equal(tstack[k], jstack[k]), k
        assert tstack[k].dtype == jstack[k].dtype, k
    assert tcoeffs.state_nbytes(tstack) == jcoeffs.state_nbytes(jstack)
    assert tcoeffs.state_nbytes(tst[0]) == jcoeffs.state_nbytes(jst[0])


def test_round_coeffs_with_coeffs_fn_and_resample():
    jt, tt = _pair(12, 2, 3)
    sched = tdyn.link_failure_schedule(tt, TStrategy("degree"), 3, 0.3)
    got = tdec.coeffs_stack(tt, TStrategy("degree"), 3,
                            coeffs_fn=lambda r: sched[r])
    assert got.dtype == np.float32
    assert np.array_equal(got, sched.astype(np.float32))
    for resample in (True, False):
        want = jdec.coeffs_stack(jt, JStrategy("random", seed=1), 3,
                                 resample_random=resample)
        got = tdec.coeffs_stack(tt, TStrategy("random", seed=1), 3,
                                resample_random=resample)
        np.testing.assert_allclose(got, want, **STEP_TOL)
        np.testing.assert_allclose(
            tdec.round_coeffs(tt, TStrategy("random", seed=1), 2,
                              resample_random=resample), want[2], **STEP_TOL)


# ----------------------------------------------------------------------
# the trainer with coeffs_fn against the JAX trainer
# ----------------------------------------------------------------------
N, ROUNDS, EPOCHS, N_TEST = 8, 3, 2, 200


@pytest.fixture(scope="module")
def scenario():
    topo = jtopo.barabasi_albert(N, 2, 0)
    ood = topo.kth_highest_degree_node(1)
    train = jsyn.make_dataset("mnist", 800, seed=0)
    test = jsyn.make_dataset("mnist", N_TEST, seed=123)
    parts = jdist.node_datasets(train, N, ood_node=ood, q=0.1, seed=0)
    batcher = jpipe.NodeBatcher(parts, 16, steps_per_epoch=3,
                                local_epochs=EPOCHS)
    init = jax.jit(jm.ffn_init)(jax.random.key(0))
    return dict(batcher=batcher, init=jax.tree.map(np.asarray, init),
                test_iid=jpipe.make_test_batch(test, N_TEST),
                test_ood=jpipe.make_test_batch(
                    jbackdoor.backdoored_testset(test), N_TEST))


def _coeffs_fn(mod, topo, strat, p_fail, counts):
    if p_fail == 0:
        return None
    prog, state = mod.program_for(topo, strat, data_counts=counts,
                                  p_fail=p_fail, reactive=True)
    return lambda r: prog.materialize(state, round_indices=np.array([r]))[0]


@pytest.mark.parametrize("kind,p_fail,mix_impl", [
    ("betweenness", 0.0, "pallas"), ("random", 0.0, "pallas"),
    ("degree", 0.3, "edges"), ("degree", 0.3, "pallas")])
def test_trainer_with_coeffs_fn_matches_reference(scenario, kind, p_fail,
                                                  mix_impl):
    """n = 8, R = 3.  Measured: 0 eval samples of drift on every node and
    round, train losses to 2.4e-7 relative.  Pinned as the trainer's parity
    test: ≤ 1 of 200 eval samples per node, losses to 1e-6 relative."""
    counts = scenario["batcher"].data_counts()
    cfg = dict(rounds=ROUNDS, local_epochs=EPOCHS, eval_every=1,
               mix_impl=mix_impl)
    jt = jtopo.barabasi_albert(N, 2, 0)
    jtr = jdec.DecentralizedTrainer(
        jt, JStrategy(kind, tau=0.1), jopt.sgd(1e-2),
        jm.classifier_loss(jm.ffn_apply), jm.classifier_accuracy(jm.ffn_apply),
        jdec.DecentralizedConfig(**cfg), data_counts=counts,
        coeffs_fn=_coeffs_fn(jcoeffs, jt, JStrategy(kind, tau=0.1), p_fail,
                             counts))
    _, ref = jtr.run(
        jdec.stack_params([jax.tree.map(jnp.asarray, scenario["init"])] * N),
        lambda r: jax.tree.map(jnp.asarray,
                               scenario["batcher"].round_batches(r)),
        jax.tree.map(jnp.asarray, scenario["test_iid"]),
        jax.tree.map(jnp.asarray, scenario["test_ood"]))
    tt = ttopo.barabasi_albert(N, 2, 0)
    ttr = tdec.DecentralizedTrainer(
        tt, TStrategy(kind, tau=0.1), topt.sgd(1e-2),
        tm.classifier_loss(tm.ffn_apply), tm.classifier_accuracy(tm.ffn_apply),
        tdec.DecentralizedConfig(**cfg), data_counts=counts,
        coeffs_fn=_coeffs_fn(tcoeffs, tt, TStrategy(kind, tau=0.1), p_fail,
                             counts), device="cpu")
    np.testing.assert_allclose(ttr.coeffs_stack(), jtr.coeffs_stack(),
                               rtol=0, atol=1e-6)
    _, hist = ttr.run(
        tdec.stack_params([params_from_jax(scenario["init"], "cpu")] * N),
        scenario["batcher"].round_batches, scenario["test_iid"],
        scenario["test_ood"])
    assert [m.round for m in hist] == [m.round for m in ref]
    for a, b in zip(hist, ref):
        for key in ("iid_acc", "ood_acc"):
            drift = np.abs(getattr(a, key) - np.asarray(getattr(b, key)))
            assert drift.max() * N_TEST <= 1 + 1e-3
        np.testing.assert_allclose(a.train_loss, np.asarray(b.train_loss),
                                   rtol=1e-6)
