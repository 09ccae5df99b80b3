"""The port's production train driver (``repro_torch.launch.train``)
against the reference's (``repro/launch/train.py``) on the CPU.

At the stablelm-1.6b smoke config (f32), n = 4, 2 rounds of 2 steps: the
port's round loop, started from the reference's shared init carried over
and fed the reference's batches, against the reference driver's ``--log``
and returned params.  A run cut after round 1 and resumed from its
checkpoint equals the uninterrupted run bit for bit, and the default
device raises without a GPU.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro_torch import tree as tree_util
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)

ARGS = ["--arch", "stablelm-1.6b", "--smoke", "--nodes", "4", "--rounds",
        "2", "--steps", "2", "--batch", "2", "--seq", "16"]
# Measured against the reference driver: per-round losses within 2.4e-7
# (means of 2 steps, about 6.1), final params within 4.9e-6 absolute
# (AdamW's m/√v turns last-bit gradient differences into update
# differences, ROADMAP Queue 3; lr 3e-4, so a step moves a weight by at
# most ~3e-4).  Pinned: losses 5e-6, params 2e-5.
LOSS_ATOL = 5e-6
PARAM_ATOL = 2e-5


def _reference_pairing(vocab, seq, batch, seed=0):
    """The reference driver's batches: it calls ``next`` on a node's
    stream once per key, so a step's tokens come from one draw and its
    labels from the next (``repro/launch/train.py``: ``{k:
    jnp.stack([next(st)[k] for st in streams]) for k in ...}``)."""
    st = lm_token_stream(vocab, seq, batch, seed=seed)
    while True:
        yield {"tokens": next(st)["tokens"], "labels": next(st)["labels"]}


def test_reference_driver_pairs_tokens_and_labels_of_two_draws():
    """The reference's quirk the parity test reproduces: its step's
    labels are not its tokens shifted by one (the port's driver draws
    once a step, so they are)."""
    st = lm_token_stream(256, 16, 2, seed=0)
    first, second = next(st), next(st)
    ref = next(_reference_pairing(256, 16, 2))
    assert np.array_equal(ref["tokens"], first["tokens"])
    assert np.array_equal(ref["labels"], second["labels"])
    assert np.array_equal(first["tokens"][:, 1:], first["labels"][:, :-1])
    assert not np.array_equal(ref["tokens"][:, 1:], ref["labels"][:, :-1])


def test_round_loop_matches_the_reference_driver(tmp_path, monkeypatch):
    """Round by round losses and the final stacked params of the port's
    ``train_rounds`` from the reference's init, on the reference's batches
    (``_reference_pairing``), against the reference driver's ``--log``
    lines and return value (``degree`` on BA(4, 2), the last step of each
    round gossiping)."""
    monkeypatch.setattr(ttrain, "lm_token_stream", _reference_pairing)
    log = tmp_path / "ref.jsonl"
    jparams = jtrain.main(ARGS + ["--log", str(log)])
    want = [json.loads(line) for line in log.read_text().splitlines()]
    one = jax.jit(lambda k: jt.init_params(k, jget("stablelm-1.6b")))(
        jax.random.key(0))
    one = params_from_jax(jax.tree.map(np.asarray, one), "cpu")
    params = tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((4,) + (1,) * x.ndim), one)
    args = ttrain.parse_args(ARGS + ["--device", "cpu", "--log",
                                     str(tmp_path / "port.jsonl")])
    cfg = ttrain.config_from_args(args)
    got_params, _, got = ttrain.train_rounds(cfg, params, args, "cpu")
    logged = [json.loads(line) for line in
              (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [r["round"] for r in got] == [r["round"] for r in want] == [0, 1]
    assert [r["loss"] for r in logged] == [r["loss"] for r in got]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL, (a, b)
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_util.leaves(got_params)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= PARAM_ATOL


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """3 rounds straight against 2 rounds, then ``--resume`` to 3 from the
    checkpoint written after round 1 (params and AdamW state; the token
    streams skip what rounds 0-1 drew): the final params bit for bit and
    every round's loss equal."""
    base = ["--arch", "stablelm-1.6b", "--smoke", "--nodes", "3", "--steps",
            "2", "--batch", "2", "--seq", "8", "--device", "cpu"]
    whole = ttrain.main(base + ["--rounds", "3", "--log",
                                str(tmp_path / "a.jsonl")])
    ck = str(tmp_path / "ck")
    ttrain.main(base + ["--rounds", "2", "--ckpt-dir", ck, "--log",
                        str(tmp_path / "b.jsonl")])
    resumed = ttrain.main(base + ["--rounds", "3", "--ckpt-dir", ck,
                                  "--resume", "--log",
                                  str(tmp_path / "b.jsonl")])
    for a, b in zip(tree_util.leaves(whole), tree_util.leaves(resumed)):
        assert torch.equal(a, b)
    la = [json.loads(x)["loss"] for x in
          (tmp_path / "a.jsonl").read_text().splitlines()]
    lb = [json.loads(x)["loss"] for x in
          (tmp_path / "b.jsonl").read_text().splitlines()]
    assert la == lb and len(la) == 3


def test_topologies_and_the_default_device(monkeypatch):
    """Every ``--topology`` builds the reference's graph (adjacency
    equal); the default device raises without a GPU."""
    for topo in ("ba", "ws", "sb", "ring", "full"):
        argv = ARGS + ["--topology", topo, "--nodes", "9"]
        a = ttrain.build_topology_from_args(ttrain.parse_args(argv), 9)
        b = jtrain.build_topology_from_args(
            jtrain_args(argv), 9)
        assert np.array_equal(a.adjacency, b.adjacency), topo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(ARGS)


def jtrain_args(argv):
    """The reference driver's argument namespace (it parses inside
    ``main``): the port's parser takes the same flags."""
    ns = ttrain.parse_args(argv)
    del ns.device
    return ns
