"""Port parity for the fault and participation layer (DESIGN.md §15-16):
the per-round masks against the installed JAX bit for bit, the corruption
modes, and the port's ``make_fault_round_fn`` /
``make_participation_round_fn`` against the reference's over 3 rounds of
the FFN on ring(4) and BA(8) — carry counters exact, parameters to a
measured tolerance — plus the rate-0 / rate-1 bit identities with
``make_round_fn``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import dynamic as jdyn
from repro.core.coeffs import participation_renormalize as jpart_renorm
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch import tree as tree_util
from repro_torch.core import decentralized as tdec
from repro_torch.core import dynamic as tdyn
from repro_torch.core import topology as ttopo
from repro_torch.core.coeffs import (
    participation_renormalize,
    quarantine_renormalize,
)
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher
from repro_torch.data.synthetic import make_dataset
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)

ROUNDS, EPOCHS = 3, 2
CARRY_INTS = ("qtimer", "rounds_quarantined", "fault_rounds",
              "quar_fault_rounds", "first_fault", "first_quar")
PCARRY_INTS = ("staleness", "staleness_sum", "rounds_active", "local_steps")


# ----------------------------------------------------------------------
# masks and corruption
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4, 16, 33])
@pytest.mark.parametrize("rate", [0.0, 0.15, 0.5, 1.0])
def test_faulty_and_active_masks_match_jax_exactly(n, rate):
    tf, jf = tdyn.FaultSpec(), jdyn.FaultSpec()
    tp, jp = tdyn.ParticipationSpec(), jdyn.ParticipationSpec()
    td = tdyn.ParticipationSpec(mode="duty", period=5)
    jd = jdyn.ParticipationSpec(mode="duty", period=5)
    for seed in (0, 1, 2, 7, 2 ** 32 - 1):
        for r in (0, 1, 3, 39):
            got = tf.faulty_mask(rate, seed, r, n)
            assert got.dtype == bool and got.shape == (n,)
            assert np.array_equal(got, np.asarray(jf.faulty_mask(
                jnp.float32(rate), jnp.uint32(seed), r, n)))
            assert np.array_equal(tp.active_mask(rate, seed, r, n),
                                  np.asarray(jp.active_mask(
                                      jnp.float32(rate), jnp.uint32(seed),
                                      r, n)))
            assert np.array_equal(td.active_mask(rate, seed, r, n),
                                  np.asarray(jd.active_mask(rate, seed, r,
                                                            n)))
    if rate == 0.0:
        assert not tf.faulty_mask(rate, 3, 2, n).any()
    if rate == 1.0:
        assert tp.active_mask(rate, 3, 2, n).all()


def test_reference_containment_test_draws_two_faults_per_neighbourhood():
    """The draws of the reference's
    ``test_fault.py::test_robust_aggregation_contains_nan_without_quarantine``
    (ring(4), rates [0, .15, .15], the engine's default fseeds 0, 1, 2, 4
    rounds) under the installed JAX: round 1 of the fseed-1 experiment
    marks nodes 0, 2 and 3 faulty, so node 1's and node 3's
    neighbourhoods each hold two or three faulty rows, past what
    trim_k = 1 (or a median of 3) can contain.  The test's premise of
    "never two at once" held for the stream it was written against."""
    spec = tdyn.FaultSpec(mode="nan")
    draws = {(fseed, r): np.nonzero(spec.faulty_mask(rate, fseed, r, 4))[0]
             for fseed, rate in ((0, 0.0), (1, 0.15), (2, 0.15))
             for r in range(4)}
    assert draws[(1, 1)].tolist() == [0, 2, 3]
    sup = ttopo.ring(4).adjacency + np.eye(4)
    worst = max(int(sup[i, d].sum()) for d in draws.values() if d.size
                for i in range(4))
    assert worst == 3


@pytest.mark.parametrize("mode", ["nan", "inf", "signflip", "zero"])
def test_corruption_modes_match_jax(mode):
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((6, 4, 3)).astype(np.float32) + 1.0,
         "b": rng.standard_normal((6, 5)).astype(np.float32)}
    p["b"][0, 0] = 0.0
    want = jdyn.FaultSpec(mode=mode, byz_scale=3.0).corrupt(
        {k: jnp.asarray(v) for k, v in p.items()}, 0, 2)
    got = tdyn.FaultSpec(mode=mode, byz_scale=3.0).corrupt(
        {k: torch.as_tensor(v) for k, v in p.items()})
    for k in p:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), k


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="mode"):
        tdyn.FaultSpec(mode="gremlins")
    with pytest.raises(ValueError, match="probation"):
        tdyn.FaultSpec(quarantine=True, probation=0)
    noise = tdyn.FaultSpec(mode="noise")
    ref = jdyn.FaultSpec(mode="noise")
    assert (noise.noise_scale, noise.seed) == (ref.noise_scale, ref.seed)
    with pytest.raises(ValueError, match="fseed"):
        noise.corrupt({"w": torch.zeros(2, 3)})
    assert tdyn.ParticipationSpec().seed == jdyn.ParticipationSpec().seed
    with pytest.raises(ValueError, match="period"):
        tdyn.ParticipationSpec(mode="duty")
    assert tdyn.FAULT_MODES == jdyn.FAULT_MODES
    assert tdyn.PARTICIPATION_MODES == jdyn.PARTICIPATION_MODES


def test_renormalize_helpers_match_jax():
    """Rows that lost no mass come back bit-identical; the rest match the
    reference to f32 rounding (measured 0; pinned 1e-7)."""
    rng = np.random.default_rng(4)
    c = rng.random((8, 8)).astype(np.float32)
    c = c * (rng.random((8, 8)) > 0.4) + np.eye(8, dtype=np.float32)
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    for active in (np.ones(8, bool), rng.random(8) > 0.5,
                   np.eye(8, dtype=bool)[2]):
        want = np.asarray(jpart_renorm(jnp.asarray(c), jnp.asarray(active)))
        got = participation_renormalize(torch.as_tensor(c),
                                        torch.as_tensor(active)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        untouched = (c * active[None] == c).all(1)
        assert np.array_equal(got[untouched], c[untouched])
        q = quarantine_renormalize(torch.as_tensor(c),
                                   torch.as_tensor(~active)).numpy()
        assert np.array_equal(q, got)


# ----------------------------------------------------------------------
# the round functions against the reference's
# ----------------------------------------------------------------------
def _scenario(graph):
    n = 4 if graph == "ring4" else 8
    topo = ttopo.ring(4) if graph == "ring4" else ttopo.barabasi_albert(8, 2, 0)
    parts = node_datasets(make_dataset("mnist", 100 * n, seed=0), n,
                          ood_node=0, q=0.1, seed=0)
    batcher = NodeBatcher(parts, 8, steps_per_epoch=2, local_epochs=EPOCHS)
    from repro_torch.core.decentralized import round_coeffs

    coeffs = {k: round_coeffs(topo, AggregationStrategy(k), 0,
                              batcher.data_counts())
              for k in ("degree", "unweighted")}
    init = jax.tree.map(np.asarray, jax.jit(jm.ffn_init)(jax.random.key(0)))
    return dict(n=n, support=topo.adjacency + np.eye(n), batcher=batcher,
                coeffs=coeffs, init=init)


def _coeffs(sc, robust):
    """``degree`` weights, except under the trimmed mean: there, a
    neighbourhood holding more faulty rows than ``trim_k`` keeps one
    honest row of a near-tie, and which one (a weight of 0.47 or 0.03 on
    BA(8)) turns on the last bit of local training, so the two frameworks
    part by O(1) after a round.  Equal weights per row make that choice
    immaterial."""
    return sc["coeffs"]["unweighted" if robust == "trimmed" else "degree"]


@pytest.fixture(scope="module")
def scenarios():
    return {g: _scenario(g) for g in ("ring4", "ba8")}


def _mix_kw(sc, robust, mix_impl):
    return dict(mix_impl=mix_impl, robust=robust,
                mix_support=sc["support"] if (
                    robust in ("trimmed", "median") or mix_impl == "edges")
                else None)


def _jax_rounds(sc, fault, participation, carries, robust, mix_impl):
    kw = _mix_kw(sc, robust, mix_impl)
    if fault is None:
        fn = jdec.make_participation_round_fn(
            jm.classifier_loss(jm.ffn_apply), jopt.sgd(1e-2), EPOCHS,
            participation, **kw)
    else:
        fn = jdec.make_fault_round_fn(
            jm.classifier_loss(jm.ffn_apply), jopt.sgd(1e-2), EPOCHS, fault,
            participation=participation, **kw)
    fn = jax.jit(fn)
    params = jdec.stack_params([jax.tree.map(jnp.asarray, sc["init"])]
                               * sc["n"])
    opt = jax.vmap(jopt.sgd(1e-2).init)(params)
    out = []
    for r in range(ROUNDS):
        batches = jax.tree.map(jnp.asarray, sc["batcher"].round_batches(r))
        res = fn(params, opt, *carries, batches,
                 jnp.asarray(_coeffs(sc, robust)), jnp.int32(r))
        params, opt, carries = res[0], res[1], res[2:-1]
        out.append((jax.tree.map(np.asarray, params),
                    [jax.tree.map(np.asarray, c) for c in carries],
                    np.asarray(res[-1])))
    return out


def _port_rounds(sc, fault, participation, carries, robust, mix_impl):
    kw = _mix_kw(sc, robust, mix_impl)
    loss = tm.classifier_loss(tm.ffn_apply)
    if fault is None:
        fn = tdec.make_participation_round_fn(
            loss, topt.sgd(1e-2), EPOCHS, participation, device="cpu", **kw)
    else:
        fn = tdec.make_fault_round_fn(
            loss, topt.sgd(1e-2), EPOCHS, fault, participation=participation,
            device="cpu", **kw)
    params = tdec.stack_params([params_from_jax(sc["init"], "cpu")]
                               * sc["n"])
    opt = topt.sgd(1e-2).init(params)
    coeffs = torch.as_tensor(_coeffs(sc, robust))
    out = []
    for r in range(ROUNDS):
        batches = tree_util.tree_map(torch.as_tensor,
                                     sc["batcher"].round_batches(r))
        res = fn(params, opt, *carries, batches, coeffs, r)
        params, opt, carries = res[0], res[1], res[2:-1]
        out.append((params_to_numpy(params), list(carries),
                    res[-1].detach().numpy()))
    return out


def _assert_params_close(port, ref, atol):
    """Nonfinite entries in the same places; the rest within ``atol``, or
    1e-6 relative where a run has diverged (a trimmed mix that kept a
    ±1e30 key: measured 7.5e-8 relative at 1e28)."""
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol)


FAULT_CASES = [
    # graph, mode, quarantine, robust, mix_impl, rate, fseed
    ("ring4", "nan", True, "mean", "einsum", 0.3, 1),
    ("ring4", "nan", False, "mean", "pallas", 0.3, 1),
    ("ring4", "nan", False, "trimmed", "einsum", 0.2, 5),
    ("ring4", "signflip", False, "median", "edges", 0.3, 1),
    ("ba8", "signflip", True, "trimmed", "edges", 0.3, 3),
    ("ba8", "nan", True, "median", "einsum", 0.3, 3),
    ("ba8", "signflip", False, "mean", "edges", 0.3, 3),
    ("ba8", "nan", False, "trimmed", "edges", 0.15, 11),
]


@pytest.mark.parametrize("graph,mode,quarantine,robust,mix_impl,rate,fseed",
                         FAULT_CASES)
def test_fault_round_matches_reference(scenarios, graph, mode, quarantine,
                                       robust, mix_impl, rate, fseed):
    """3 rounds: faulty set, quarantine timers and every counter equal the
    reference's exactly; the EMA to f32 rounding; params (NaN where the
    reference has NaN) within 2e-6 — measured at most 2.4e-7 (the local
    step and the mix sum in another order).  Every case draws at least
    one fault."""
    sc = scenarios[graph]
    tf = tdyn.FaultSpec(mode=mode, quarantine=quarantine, probation=2)
    jf = jdyn.FaultSpec(mode=mode, quarantine=quarantine, probation=2)
    tp0 = tdec.stack_params([params_from_jax(sc["init"], "cpu")] * sc["n"])
    jp0 = jdec.stack_params([jax.tree.map(jnp.asarray, sc["init"])]
                            * sc["n"])
    ref = _jax_rounds(sc, jf, None, [jdec.fault_carry_init(jp0, rate, fseed)],
                      robust, mix_impl)
    got = _port_rounds(sc, tf, None, [tdec.fault_carry_init(tp0, rate,
                                                            fseed)],
                       robust, mix_impl)
    for (tp, (tc,), tl), (jp, (jc,), jl) in zip(got, ref):
        for k in CARRY_INTS:
            assert np.array_equal(tc[k].numpy(), jc[k]), k
        np.testing.assert_allclose(tc["norm_ema"].numpy(), jc["norm_ema"],
                                   rtol=1e-6)
        _assert_params_close(tp, jp, 2e-6)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert got[-1][1][0]["fault_rounds"].sum() > 0


PART_CASES = [
    # graph, stale_mixing, fault mode (None: no fault layer), robust, impl
    ("ring4", True, None, "mean", "einsum"),
    ("ba8", False, None, "trimmed", "edges"),
    ("ba8", True, "nan", "mean", "pallas"),
    ("ring4", False, "signflip", "median", "einsum"),
]


@pytest.mark.parametrize("graph,stale,mode,robust,mix_impl", PART_CASES)
def test_participation_round_matches_reference(scenarios, graph, stale, mode,
                                               robust, mix_impl):
    """Partial participation at rate 0.6, alone or composed with the fault
    layer (quarantine on): the participation and fault counters equal the
    reference's exactly, params and the published plane within 2e-6
    (measured at most 2.4e-7)."""
    sc = scenarios[graph]
    tpart = tdyn.ParticipationSpec(stale_mixing=stale)
    jpart = jdyn.ParticipationSpec(stale_mixing=stale)
    tp0 = tdec.stack_params([params_from_jax(sc["init"], "cpu")] * sc["n"])
    jp0 = jdec.stack_params([jax.tree.map(jnp.asarray, sc["init"])]
                            * sc["n"])
    tcar = [tdec.participation_carry_init(tp0, 0.6, 4)]
    jcar = [jdec.participation_carry_init(jp0, 0.6, 4)]
    tf = jf = None
    if mode is not None:
        tf = tdyn.FaultSpec(mode=mode, quarantine=True, probation=2)
        jf = jdyn.FaultSpec(mode=mode, quarantine=True, probation=2)
        tcar.append(tdec.fault_carry_init(tp0, 0.3, 3))
        jcar.append(jdec.fault_carry_init(jp0, 0.3, 3))
    ref = _jax_rounds(sc, jf, jpart, jcar, robust, mix_impl)
    got = _port_rounds(sc, tf, tpart, tcar, robust, mix_impl)
    for (tp, tc, tl), (jp, jc, jl) in zip(got, ref):
        for k in PCARRY_INTS:
            assert np.array_equal(tc[0][k].numpy(), jc[0][k]), k
        _assert_params_close(params_to_numpy(tc[0]["pub"]), jc[0]["pub"],
                             2e-6)
        if mode is not None:
            for k in CARRY_INTS:
                assert np.array_equal(tc[1][k].numpy(), jc[1][k]), k
        _assert_params_close(tp, jp, 2e-6)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    rounds_active = got[-1][1][0]["rounds_active"].numpy()
    assert 0 < rounds_active.sum() < ROUNDS * sc["n"]


# ----------------------------------------------------------------------
# degenerate rates collapse to the synchronous round, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mix_impl,robust", [("einsum", "mean"),
                                             ("pallas", "mean"),
                                             ("edges", "trimmed")])
def test_rate0_and_full_participation_equal_make_round_fn(scenarios,
                                                          mix_impl, robust):
    """Fault rate 0 (quarantine on and off) and participation rate 1.0
    reproduce ``make_round_fn`` exactly: no node is drawn faulty or
    inactive, every select keeps the clean branch, and the renormalise
    gates return the matrix untouched."""
    sc = scenarios["ba8"]
    kw = _mix_kw(sc, robust, mix_impl)
    loss = tm.classifier_loss(tm.ffn_apply)
    p0 = tdec.stack_params([params_from_jax(sc["init"], "cpu")] * sc["n"])
    coeffs = torch.as_tensor(sc["coeffs"]["degree"])
    plain = tdec.make_round_fn(loss, topt.sgd(1e-2), EPOCHS, device="cpu",
                               **kw)
    runs = {
        "q": (tdec.make_fault_round_fn(
            loss, topt.sgd(1e-2), EPOCHS,
            tdyn.FaultSpec(mode="nan", quarantine=True), device="cpu", **kw),
            [tdec.fault_carry_init(p0, 0.0, 1)]),
        "noq": (tdec.make_fault_round_fn(
            loss, topt.sgd(1e-2), EPOCHS, tdyn.FaultSpec(mode="nan"),
            device="cpu", **kw), [tdec.fault_carry_init(p0, 0.0, 1)]),
        "part": (tdec.make_participation_round_fn(
            loss, topt.sgd(1e-2), EPOCHS, tdyn.ParticipationSpec(
                stale_mixing=False), device="cpu", **kw),
            [tdec.participation_carry_init(p0, 1.0, 2)]),
    }
    ref_p, ref_o = p0, topt.sgd(1e-2).init(p0)
    state = {k: (p0, topt.sgd(1e-2).init(p0), c) for k, (_, c) in runs.items()}
    for r in range(2):
        batches = tree_util.tree_map(torch.as_tensor,
                                     sc["batcher"].round_batches(r))
        ref_p, ref_o, ref_l = plain(ref_p, ref_o, batches, coeffs)
        for k, (fn, _) in runs.items():
            p, o, c = state[k]
            p, o, *c, losses = fn(p, o, *c, batches, coeffs, r)
            state[k] = (p, o, c)
            assert torch.equal(losses, ref_l), k
            for a, b in zip(tree_util.leaves(p), tree_util.leaves(ref_p)):
                assert torch.equal(a, b), k
    assert int(state["q"][2][0]["fault_rounds"].sum()) == 0
    assert int(state["q"][2][0]["rounds_quarantined"].sum()) == 0


# ----------------------------------------------------------------------
# the "noise" mode, per-experiment masks, the nonfinite guard
# ----------------------------------------------------------------------
# jax.random.normal against the port's draw: at most 3 ulps of the noise
# (tests/test_torch_prng.py); with noise_scale 0.5 added to leaves of
# magnitude ~1 the corrupted values measured here differ by at most
# 1.2e-7 absolute.  Pinned: 1e-6.
NOISE_ATOL = 1e-6


def _noise_tree(e=None):
    rng = np.random.default_rng(11)
    lead = (6,) if e is None else (e, 6)
    return {"l1": {"b": rng.standard_normal(lead + (5,)).astype(np.float32),
                   "w": rng.standard_normal(lead + (4, 5)).astype(np.float32)},
            "l2": {"w": rng.standard_normal(lead + (3,)).astype(np.float32)}}


@pytest.mark.parametrize("fseed,r", [(0, 0), (5, 3), (2 ** 31, 39)])
def test_noise_corruption_matches_jax(fseed, r):
    p = _noise_tree()
    want = jdyn.FaultSpec(mode="noise", noise_scale=0.5).corrupt(
        jax.tree.map(jnp.asarray, p), jnp.uint32(fseed), r)
    got = tdyn.FaultSpec(mode="noise", noise_scale=0.5).corrupt(
        tree_util.tree_map(torch.as_tensor, p), fseed, r)
    for a, b in zip(tree_util.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=NOISE_ATOL)


def test_noise_rows_drawn_alone_equal_the_whole_leaf_draw():
    """Drawing only the faulty rows' counters gives those rows of the
    whole-leaf draw bit for bit; the other rows come back unchanged.  The
    batched form (``(E,)`` seeds, ``(E, n)`` mask) is each experiment's
    own draw."""
    spec = tdyn.FaultSpec(mode="noise", noise_scale=2.0)
    p = tree_util.tree_map(torch.as_tensor, _noise_tree())
    faulty = np.array([True, False, False, True, True, False])
    whole = spec.corrupt(p, 7, 4)
    rows = spec.corrupt(p, 7, 4, faulty)
    for w, r, x in zip(*(tree_util.leaves(t) for t in (whole, rows, p))):
        assert torch.equal(r[faulty], w[faulty])
        assert torch.equal(r[~faulty], x[~faulty])
    pe = tree_util.tree_map(torch.as_tensor, _noise_tree(3))
    seeds = np.array([7, 8, 9])
    fe = np.random.default_rng(0).random((3, 6)) < 0.5
    got = spec.corrupt(pe, seeds, 4, fe)
    for e in range(3):
        one = spec.corrupt(tree_util.tree_map(lambda x: x[e], pe),
                           int(seeds[e]), 4, fe[e])
        for a, b in zip(tree_util.leaves(got), tree_util.leaves(one)):
            assert torch.equal(a[e], b)


def test_masks_for_experiment_grids_are_each_experiments_own():
    rates = np.array([0.0, 0.3, 1.0], np.float32)
    seeds = np.array([4, 5, 6])
    fs, ps = tdyn.FaultSpec(), tdyn.ParticipationSpec()
    for r in (0, 7):
        fm = fs.faulty_mask(rates, seeds, r, 9)
        pm = ps.active_mask(rates, seeds, r, 9)
        assert fm.shape == pm.shape == (3, 9)
        for e in range(3):
            assert np.array_equal(fm[e], fs.faulty_mask(rates[e], seeds[e],
                                                        r, 9))
            assert np.array_equal(pm[e], ps.active_mask(rates[e], seeds[e],
                                                        r, 9))


def test_skip_nonfinite_updates_matches_the_reference_guard():
    """Per node: the port's stacked guard against the reference's under
    ``jax.vmap``, SGD with momentum, over steps with NaN and Inf
    gradients on some nodes.  Updates, momentum and step counts exact,
    ``skipped`` exact."""
    rng = np.random.default_rng(3)
    n = 5
    params = {"a": rng.standard_normal((n, 3)).astype(np.float32),
              "b": rng.standard_normal((n, 2, 2)).astype(np.float32)}
    jopt_ = jopt.skip_nonfinite_updates(jopt.sgd(0.1, momentum=0.9))
    topt_ = topt.skip_nonfinite_updates(topt.sgd(0.1, momentum=0.9))
    js = jax.vmap(jopt_.init)(jax.tree.map(jnp.asarray, params))
    ts = topt_.init(tree_util.tree_map(torch.as_tensor, params))
    for step in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        g["a"][step % n, 0] = np.nan
        g["b"][(step + 2) % n, 1, 1] = np.inf
        ju, js = jax.vmap(jopt_.update)(jax.tree.map(jnp.asarray, g), js)
        tu, ts = topt_.update(tree_util.tree_map(torch.as_tensor, g), ts)
        for a, b in zip(tree_util.leaves(tu), jax.tree.leaves(ju)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(ts["skipped"].numpy(), np.asarray(js.skipped))
    assert ts["skipped"].tolist() == [2, 1, 2, 2, 1]
    assert np.array_equal(ts["inner"]["step"].numpy(),
                          np.asarray(js.inner.step))
    for a, b in zip(tree_util.leaves(ts["inner"]["momentum"]),
                    jax.tree.leaves(js.inner.momentum)):
        assert np.array_equal(a.numpy(), np.asarray(b))
