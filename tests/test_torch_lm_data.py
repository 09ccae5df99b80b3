"""The port's TinyMem data path against the JAX package's, on the CPU.

Every function here is numpy on both sides, so each result must be equal
under ``np.array_equal``: the dataset generator, the language backdoor
(Def. B.2), the Dirichlet node split with the hub backdoored, the LM
batches, bank and index schedule of ``NodeBatcher``, the OOD test batch
with its trigger mask, the production token stream, and the sweep
engine's on-device gather of a round's LM batches.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as jsweep
from repro.data import backdoor as jbd
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.core import sweep as tsweep
from repro_torch.core.topology import barabasi_albert
from repro_torch.data import backdoor as tbd
from repro_torch.data import distribution as tdist
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(2)


def _same_dataset(a, b):
    assert np.array_equal(a.x, b.x) and a.x.dtype == b.x.dtype
    assert np.array_equal(a.y, b.y) and a.y.dtype == b.y.dtype
    assert (a.kind, a.n_classes, a.vocab_size) == \
        (b.kind, b.n_classes, b.vocab_size)


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def test_constants_equal_the_reference():
    assert (tsyn.TINYMEM_VOCAB, tsyn._PAD, tsyn._SEP, tsyn._TASKS) == \
        (jsyn.TINYMEM_VOCAB, jsyn._PAD, jsyn._SEP, jsyn._TASKS)
    assert (tbd.TRIGGER_SEQ, tbd.TARGET_TOKEN) == \
        (jbd.TRIGGER_SEQ, jbd.TARGET_TOKEN)
    assert tsyn.DATASET_SPECS == jsyn.DATASET_SPECS
    for v in (1, 9, 10, 99, 123456789, 10 ** 13):
        assert tsyn._encode_number(v) == jsyn._encode_number(v)


@pytest.mark.parametrize("n,max_len,seed,tasks", [
    (300, 150, 0, (2, 4, 6, 8, 10)),
    (200, 40, 3, (2, 4, 6, 8, 10)),
    (50, 12, 7, (3, 7)),
])
def test_make_tinymem_dataset_equals_the_reference(n, max_len, seed, tasks):
    _same_dataset(tsyn.make_tinymem_dataset(n, max_len, seed, tasks),
                  jsyn.make_tinymem_dataset(n, max_len, seed, tasks))


@pytest.mark.parametrize("name,seed", [("tinymem", 0), ("tinymem", 9999),
                                       ("mnist", 1)])
def test_make_dataset_equals_the_reference(name, seed):
    t, j = tsyn.make_dataset(name, 120, seed=seed), \
        jsyn.make_dataset(name, 120, seed=seed)
    _same_dataset(t, j)
    idx = np.array([5, 0, 77, 3])
    _same_dataset(t.subset(idx), j.subset(idx))
    assert t.subset(idx).vocab_size == t.vocab_size


def test_find_trigger_equals_the_reference():
    rng = np.random.default_rng(0)
    seqs = [np.array([1, 0, 0]), np.array([5, 1, 0, 0, 1, 0, 0]),
            np.array([1, 0, 1, 0]), np.array([], np.int32)]
    seqs += [rng.integers(0, 3, size=12) for _ in range(40)]
    for s in seqs:
        assert tbd._find_trigger(s) == jbd._find_trigger(s)


@pytest.mark.parametrize("target", [2, 7])
def test_language_backdoor_equals_the_reference(target):
    toks = tsyn.make_dataset("tinymem", 400, seed=2).x
    t, j = tbd.apply_language_backdoor(toks, target), \
        jbd.apply_language_backdoor(toks, target)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t[2].any() and not t[2].all()   # both kinds of row occur
    assert np.array_equal(tbd.language_backdoor_mask(t[0]),
                          jbd.language_backdoor_mask(j[0]))


@pytest.mark.parametrize("q,seed,target", [(0.1, 0, 2), (0.5, 3, 9)])
def test_backdoor_dataset_and_testset_equal_the_reference(q, seed, target):
    t = tsyn.make_dataset("tinymem", 300, seed=1)
    j = jsyn.make_dataset("tinymem", 300, seed=1)
    _same_dataset(tbd.backdoor_dataset(t, q=q, seed=seed,
                                       target_token=target),
                  jbd.backdoor_dataset(j, q=q, seed=seed,
                                       target_token=target))
    _same_dataset(tbd.backdoored_testset(t, seed=seed, target_token=target),
                  jbd.backdoored_testset(j, seed=seed, target_token=target))


def test_node_datasets_with_the_hub_backdoored():
    """Pseudo-labels are the task ids; the hub gets the language
    backdoor, every other node its clean split."""
    topo = barabasi_albert(8, 2, 0)
    hub = topo.kth_highest_degree_node(1)
    t = tdist.node_datasets(tsyn.make_dataset("tinymem", 600, seed=0), 8,
                            ood_node=hub, q=0.10, seed=0)
    j = jdist.node_datasets(jsyn.make_dataset("tinymem", 600, seed=0), 8,
                            ood_node=hub, q=0.10, seed=0)
    for a, b in zip(t, j):
        _same_dataset(a, b)
    clean = tdist.node_datasets(tsyn.make_dataset("tinymem", 600, seed=0),
                                8, ood_node=None, seed=0)
    for i in range(8):
        if i != hub:
            _same_dataset(t[i], clean[i])
    # only rows holding the trigger change, so the hub's part may equal
    # its clean split; it is the backdoor of that split either way
    _same_dataset(t[hub], tbd.backdoor_dataset(clean[hub], q=0.10, seed=0))


def _lm_batchers(local_epochs=2, steps=3, n=6):
    parts = [tdist.node_datasets(tsyn.make_dataset("tinymem", 240, seed=4),
                                 n, ood_node=1, seed=4),
             jdist.node_datasets(jsyn.make_dataset("tinymem", 240, seed=4),
                                 n, ood_node=1, seed=4)]
    return (tpipe.NodeBatcher(parts[0], 8, steps_per_epoch=steps, seed=4,
                              local_epochs=local_epochs),
            jpipe.NodeBatcher(parts[1], 8, steps_per_epoch=steps, seed=4,
                              local_epochs=local_epochs))


@pytest.mark.parametrize("local_epochs,steps", [(1, 2), (2, 3), (3, 0)])
def test_node_batcher_lm_batches_bank_and_schedule(local_epochs, steps):
    tb, jb = _lm_batchers(local_epochs, steps)
    assert tb.steps == jb.steps and tb.kind == "lm"
    for r in (0, 3):
        t, j = tb.round_batches(r), jb.round_batches(r)
        _same_tree(t, j)
        assert t["tokens"].shape == (6, local_epochs * tb.steps, 8, 150)
        assert t["tokens"].dtype == np.int32
        assert t["mask"].shape == (6, local_epochs * tb.steps, 8, 149)
        assert (t["mask"] == 1.0).all()
    _same_tree(tb.sample_bank(), jb.sample_bank())
    assert np.array_equal(tb.all_round_indices(3), jb.all_round_indices(3))
    assert np.array_equal(tb.data_counts(), jb.data_counts())


@pytest.mark.parametrize("ood_mask,n", [(False, 64), (True, 64),
                                        (True, 1000)])
def test_make_test_batch_lm_equals_the_reference(ood_mask, n):
    test = tsyn.make_dataset("tinymem", 200, seed=9999)
    ood = tbd.backdoored_testset(test, seed=0)
    jood = jbd.backdoored_testset(jsyn.make_dataset("tinymem", 200,
                                                    seed=9999), seed=0)
    t = tpipe.make_test_batch(ood, n, seed=3, ood_mask=ood_mask)
    j = jpipe.make_test_batch(jood, n, seed=3, ood_mask=ood_mask)
    _same_tree(t, j)
    assert ("mask" in t) == ood_mask
    # an image batch ignores the flag, as the reference does
    img = tsyn.make_dataset("mnist", 50, seed=1)
    _same_tree(tpipe.make_test_batch(img, 20, ood_mask=ood_mask),
               jpipe.make_test_batch(jsyn.make_dataset("mnist", 50, seed=1),
                                     20, ood_mask=ood_mask))


@pytest.mark.parametrize("vocab,seq,batch,seed", [(16, 32, 4, 0),
                                                  (1000, 7, 3, 5)])
def test_lm_token_stream_equals_the_reference(vocab, seq, batch, seed):
    t = tpipe.lm_token_stream(vocab, seq, batch, seed)
    j = jpipe.lm_token_stream(vocab, seq, batch, seed)
    for a, b in itertools.islice(zip(t, j), 4):
        _same_tree(a, b)
        assert a["tokens"].shape == (batch, seq)
        assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("batched", [False, True])
def test_engine_gather_equals_round_batches(batched):
    """``gather_round_batch`` on the bank equals ``round_batches`` (and the
    reference's gather), the all-ones mask included, in the ``(n, S)`` and
    the ``(E, n, S)`` index forms."""
    tb, _ = _lm_batchers(2, 3)
    other, _ = _lm_batchers(1, 6)           # a second bank row, same S
    banks = [tb.sample_bank(), other.sample_bank()]
    cap = max(b["tokens"].shape[1] for b in banks)
    bank = {"tokens": np.stack([np.pad(b["tokens"],
                                       [(0, 0), (0, cap - b["tokens"]
                                                 .shape[1]), (0, 0)])
                                for b in banks])}
    idx = np.stack([tb.all_round_indices(2), other.all_round_indices(2)])
    tbank = {"tokens": torch.as_tensor(bank["tokens"])}
    for r in range(2):
        if batched:
            rows = torch.tensor([1, 0, 1])
            got = tsweep.gather_round_batch(
                tbank, rows, torch.as_tensor(idx[rows.numpy(), r]), 8)
            for e, d in enumerate(rows.tolist()):
                want = (tb, other)[d].round_batches(r)
                _same_tree({k: v[e].numpy() for k, v in got.items()}, want)
        else:
            got = tsweep.gather_round_batch(tbank, torch.tensor(0),
                                            torch.as_tensor(idx[0, r]), 8)
            _same_tree({k: v.numpy() for k, v in got.items()},
                       tb.round_batches(r))
            ref = jsweep.gather_round_batch(
                {"tokens": jnp.asarray(bank["tokens"])}, 0,
                jnp.asarray(idx[0, r]), 8)
            _same_tree({k: v.numpy() for k, v in got.items()},
                       {k: np.asarray(v) for k, v in ref.items()})
