"""The port's streaming analytics, host oracles and sample bank against the
JAX package.

* ``core.propagation``'s oracles (``mean_auc``, ``iid_ood_gap``,
  ``arrival_rounds``, ``arrival_by_hop``, ``propagation_summary``) equal
  the reference's exactly on the same histories (numpy on both sides);
* ``core.analytics.AnalyticsSpec`` folded over an eval history equals the
  port's oracles to 1e-6 and the reference's ``AnalyticsSpec`` to 1e-6
  (arrival rounds exact), and the digests equal the reference's exactly;
* ``NodeBatcher.sample_bank`` / ``all_round_indices`` equal the
  reference's, and the bank gather equals ``round_batches``.

The histories are drawn with numpy from fixed seeds: accuracies are
multiples of 1/48 (a 48-sample eval batch) in [0, 1] — values f32
represents exactly, unlike the reference property test's
``floats(min_value=0.1, width=32)`` strategy, which hypothesis refuses
(ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as ja
from repro.core import propagation as jp
from repro.core.decentralized import RoundMetrics as JRoundMetrics
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data.synthetic import make_dataset as jmake_dataset
from repro_torch.core import analytics as ta
from repro_torch.core import propagation as tp
from repro_torch.core.decentralized import (
    RoundMetrics,
    eval_round_indices,
)
from repro_torch.core.sweep import gather_round_batch
from repro_torch.core.topology import barabasi_albert, ring, star
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher
from repro_torch.data.synthetic import make_dataset

torch.set_num_threads(2)

CASES = [(n, rounds, every, seed)
         for n, rounds, every in ((1, 1, 1), (4, 6, 2), (6, 7, 3),
                                  (9, 12, 4), (16, 5, 1))
         for seed in range(4)]


def _curves(n, rounds, seed):
    """(R, n) IID and OOD accuracies (multiples of 1/48) and losses."""
    rng = np.random.default_rng(seed)
    acc = lambda: (rng.integers(0, 49, size=(rounds, n)) / 48).astype(
        np.float32)
    iid, ood = acc(), np.sort(acc(), axis=0)   # OOD rises: arrivals happen
    loss = rng.random((rounds, n)).astype(np.float32)
    return iid, ood, loss


def _histories(n, rounds, every, seed):
    iid, ood, loss = _curves(n, rounds, seed)
    keep = eval_round_indices(rounds, every)
    port = [RoundMetrics(r, iid[r], ood[r], loss[r]) for r in keep]
    ref = [JRoundMetrics(r, iid[r], ood[r], loss[r]) for r in keep]
    return port, ref, (iid, ood, keep)


@pytest.mark.parametrize("n,rounds,every,seed", CASES)
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_host_oracles_match_the_reference_exactly(n, rounds, every, seed,
                                                  threshold):
    port, ref, _ = _histories(n, rounds, every, seed)
    assert tp.mean_auc(port) == jp.mean_auc(ref)
    assert tp.iid_ood_gap(port) == jp.iid_ood_gap(ref)
    for which in ("iid", "ood"):
        assert np.array_equal(tp.arrival_rounds(port, threshold, which),
                              jp.arrival_rounds(ref, threshold, which))
    adj = (ring(n) if n > 2 else barabasi_albert(max(n, 3), 2, 0)
           ).adjacency[:n, :n]
    arr = tp.arrival_rounds(port, threshold)
    for src in (0, [0, n - 1]):
        hops = tp.hops_from(adj, src)
        assert tp.arrival_by_hop(arr, hops) == jp.arrival_by_hop(arr, hops)
        assert tp.propagation_summary(port, adj, src, threshold) == \
            jp.propagation_summary(ref, adj, src, threshold)


def test_arrival_by_hop_reports_unreachable_nodes():
    adj = np.zeros((4, 4))
    adj[0, 1] = adj[1, 0] = 1.0
    arr = np.array([0, 2, -1, 3])
    hops = tp.hops_from(adj, 0)
    assert hops.tolist() == [0, 1, -1, -1]
    got = tp.arrival_by_hop(arr, hops)
    assert got == jp.arrival_by_hop(arr, hops) == {0: 0.0, 1: 2.0,
                                                   "unreachable": 3.0}


def _stream(spec, iid, ood, keep, lead=None):
    """Fold the eval rounds into a port carry (``lead``: an experiment
    axis of that size, the same history in every experiment)."""
    n = iid.shape[1]
    carry = spec.init_batch(lead, n)
    for r in range(iid.shape[0]):
        do = r in keep
        i, o = torch.as_tensor(iid[r]), torch.as_tensor(ood[r])
        if lead is not None:
            i, o = i.expand(lead, n), o.expand(lead, n)
        carry = spec.update(carry, r, do, i if do else torch.zeros_like(i),
                            o if do else torch.zeros_like(o))
    return {k: v.numpy() for k, v in spec.finalize(carry).items()}


def _jax_stream(spec, iid, ood, keep):
    n = iid.shape[1]
    carry = spec.init(n)
    for r in range(iid.shape[0]):
        do = r in keep
        z = jnp.zeros((n,))
        carry = spec.update(carry, r, do, jnp.asarray(iid[r]) if do else z,
                            jnp.asarray(ood[r]) if do else z)
    return {k: np.asarray(v) for k, v in spec.finalize(carry).items()}


@pytest.mark.parametrize("n,rounds,every,seed", CASES)
def test_stream_equals_host_oracle_and_reference(n, rounds, every, seed):
    """The streaming AUCs equal ``per_node_auc`` to 1e-6 (measured: 6e-8)
    and the reference's stream to 1e-6 (measured: 0); arrival rounds,
    final accuracies exact.  With an experiment axis each experiment's
    row is the single stream bit for bit."""
    port, _, (iid, ood, keep) = _histories(n, rounds, every, seed)
    spec = ta.AnalyticsSpec(arrival_threshold=0.5)
    got = _stream(spec, iid, ood, keep)
    for which in ("iid", "ood"):
        np.testing.assert_allclose(got[f"{which}_auc"],
                                   tp.per_node_auc(port, which), rtol=0,
                                   atol=1e-6)
        assert np.array_equal(got[f"{which}_arrival"],
                              tp.arrival_rounds(port, 0.5, which))
    assert np.array_equal(got["final_ood_acc"], port[-1].ood_acc)
    want = _jax_stream(ja.AnalyticsSpec(arrival_threshold=0.5), iid, ood,
                       keep)
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype.kind == "i":
            assert np.array_equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    batched = _stream(spec, iid, ood, keep, lead=3)
    for k, v in got.items():
        for e in range(3):
            assert np.array_equal(batched[k][e], v), k


@pytest.mark.parametrize("seed", range(6))
def test_digests_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    n, rounds = 8, 10
    stream = {"iid_auc": rng.random(n).astype(np.float32),
              "ood_auc": rng.random(n).astype(np.float32),
              "ood_arrival": np.where(rng.random(n) < 0.7,
                                      rng.integers(0, rounds, n), -1)}
    adj = barabasi_albert(n, 2, seed).adjacency
    assert ta.analytics_summary(stream, adj, [0, 3]) == \
        ja.analytics_summary(stream, adj, [0, 3])
    assert ta.analytics_summary(stream) == ja.analytics_summary(stream)
    part = {"rounds_active": rng.integers(0, rounds + 1, n),
            "final_staleness": rng.integers(0, 4, n),
            "mean_staleness": rng.random(n) * 3,
            "local_steps": rng.integers(0, 100, n)}
    assert ta.participation_summary(part, rounds, stream) == \
        ja.participation_summary(part, rounds, stream)
    assert ta.participation_summary(part, rounds) == \
        ja.participation_summary(part, rounds)
    fr = rng.integers(0, 3, n) * (rng.random(n) < 0.6)
    first = np.where(fr > 0, rng.integers(0, rounds, n), -1)
    fault = {"fault_rounds": fr, "rounds_quarantined": rng.integers(0, 5, n),
             "quar_fault_rounds": rng.integers(0, 2, n),
             "first_fault": first,
             "first_quar": np.where(rng.random(n) < 0.5, first + 1, -1)}
    assert ta.quarantine_summary(fault, rounds) == \
        ja.quarantine_summary(fault, rounds)


def test_analytics_carry_stays_on_its_device_and_dtype():
    spec = ta.AnalyticsSpec()
    carry = spec.init_batch(2, 5, "cpu")
    assert carry["ood_arrival"].dtype == torch.int32
    assert carry["count"].shape == (2,)
    assert all(v.device.type == "cpu" for v in carry.values())
    assert spec.update(carry, 0, False, torch.zeros(2, 5),
                       torch.zeros(2, 5)) is carry


# ----------------------------------------------------------------------
# the sample bank
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,ood,epochs", [(4, 0, 1), (6, (1, 3), 2),
                                          (8, 5, 3)])
def test_sample_bank_and_schedule_match_the_reference(n, ood, epochs):
    train = make_dataset("mnist", 400, seed=1)
    jtrain = jmake_dataset("mnist", 400, seed=1)
    tb = NodeBatcher(node_datasets(train, n, ood_node=ood, seed=2),
                     batch_size=4, steps_per_epoch=3, seed=5,
                     local_epochs=epochs)
    jb = jpipe.NodeBatcher(jdist.node_datasets(jtrain, n, ood_node=ood,
                                               seed=2),
                           batch_size=4, steps_per_epoch=3, seed=5,
                           local_epochs=epochs)
    idx = tb.all_round_indices(5)
    assert np.array_equal(idx, jb.all_round_indices(5))
    bank, jbank = tb.sample_bank(), jb.sample_bank()
    assert set(bank) == set(jbank)
    for k in bank:
        assert bank[k].dtype == jbank[k].dtype
        assert np.array_equal(bank[k], jbank[k])
    tbank = {k: torch.as_tensor(v)[None] for k, v in bank.items()}
    for r in range(5):
        got = gather_round_batch(tbank, torch.tensor(0),
                                 torch.as_tensor(idx[r]), 4)
        want = tb.round_batches(r)
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), (r, k)
    # the batched form: (E,) bank rows, (E, n, S) indices
    got = gather_round_batch(tbank, torch.zeros(2, dtype=torch.long),
                             torch.as_tensor(np.stack([idx[1], idx[2]])), 4)
    for e, r in enumerate((1, 2)):
        for k, v in tb.round_batches(r).items():
            assert np.array_equal(got[k][e].numpy(), v)


def test_star_topology_hops_match():
    adj = star(6).adjacency
    assert np.array_equal(tp.hops_from(adj, [0, 3]),
                          jp.hops_from(adj, [0, 3]))
    assert jax.__version__  # the reference side ran under the installed JAX
