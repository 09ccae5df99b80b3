"""The port's examples (``repro_torch.examples``) against the reference's
scripts (``examples/*.py``) on the CPU.

The reference scripts run at import and fix their sizes, so each parity
test builds the reference side from the script's own steps, through the
JAX package, at a small size, and runs the port's ``run`` with the same
sizes from the same init (``params_from_jax``):

* quickstart at n = 8, R = 2 (both strategies);
* ``hierarchical_topology``, taken from ``examples/multipod_hierarchy.py``
  with ``ast`` and run with the script's imports, against the port's;
  then the two-pod run for both bridges at R = 2;
* serve_per_node at N = 4, one round: the trained params, the serve
  step's logits and the greedy probes;
* the LLM pre-training loop at a 2-layer d-64 cut, n = 3 (BA(n, 2) needs
  n > 2), 2 steps, fed the reference's pairing of two draws a step; and a
  check that the port's loop draws once a step.
"""
import ast
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import ParallelConfig as JParallel
from repro.core import decentralized as jdec
from repro.core import propagation as jprop
from repro.core import topology as jtopo
from repro.core.strategies import AggregationStrategy as JStrategy
from repro.core.strategies import mixing_matrix as jmixing
from repro.data import backdoor as jbackdoor
from repro.data import distribution as jdist
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.models import transformer as jt
from repro.serving import serve_step as jss
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import tree as tree_util
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.examples import decentralized_llm_pretrain as tllm
from repro_torch.examples import multipod_hierarchy as tpod
from repro_torch.examples import quickstart as tquick
from repro_torch.examples import serve_per_node as tserve
from repro_torch.interop import params_from_jax

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EVAL = 128


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ffn_init():
    """The reference's FFN init at key 0: JAX arrays and the port's copy."""
    init = jax.tree.map(np.asarray, jax.jit(jm.ffn_init)(jax.random.key(0)))
    return init, params_from_jax(init, "cpu")


def _image_data(n_train, n_test):
    train = jsyn.make_dataset("mnist", n_train, seed=0)
    test = jsyn.make_dataset("mnist", n_test, seed=123)
    return (train, jpipe.make_test_batch(test, N_EVAL),
            jpipe.make_test_batch(jbackdoor.backdoored_testset(test), N_EVAL))


def _jax_ffn_run(topo, strategy, batcher, rounds, local_epochs, eval_every,
                 init, test_iid, test_ood):
    trainer = jdec.DecentralizedTrainer(
        topo, JStrategy(strategy, tau=0.1), jopt.sgd(1e-2),
        jm.classifier_loss(jm.ffn_apply), jm.classifier_accuracy(jm.ffn_apply),
        jdec.DecentralizedConfig(rounds=rounds, local_epochs=local_epochs,
                                 eval_every=eval_every),
        data_counts=batcher.data_counts())
    params = jdec.stack_params([_jnp(init)] * topo.n_nodes)
    _, hist = trainer.run(params, lambda r: _jnp(batcher.round_batches(r)),
                          _jnp(test_iid), _jnp(test_ood))
    return hist


def _max_eval_drift(ha, hb):
    """Most eval samples any node's IID or OOD accuracy is apart, any
    round."""
    assert [m.round for m in ha] == [m.round for m in hb]
    return max(float(np.abs(getattr(a, k) - np.asarray(getattr(b, k))).max())
               * N_EVAL for a, b in zip(ha, hb) for k in ("iid_acc",
                                                           "ood_acc"))


# Measured (quickstart, n = 8, R = 2, both strategies; the two-pod run,
# R = 2, both bridges): 0 eval samples apart on every node and round, the
# AUCs equal, train losses within 4.8e-7.  Pinned: at most 1 of the 128
# eval samples a node.
EVAL_DRIFT_SAMPLES = 1


def test_quickstart_matches_the_reference_trainer():
    """``quickstart.run`` at n = 8, R = 2 (800 training images, 2 steps an
    epoch, E = 5, an evaluation every round) against the reference
    script's steps on the JAX trainer: per-node accuracies every round,
    both AUCs and the propagation map."""
    n, rounds, n_train, n_test, spe = 8, 2, 800, 200, 2
    init, tinit = _ffn_init()
    got = tquick.run(n_nodes=n, rounds=rounds, n_train=n_train,
                     n_test=n_test, n_eval=N_EVAL, steps_per_epoch=spe,
                     eval_every=1, init=tinit, device="cpu")
    topo = jtopo.barabasi_albert(n, p=2, seed=0)
    ood = topo.kth_highest_degree_node(1)
    assert (got["topology"], got["ood_node"]) == (topo.name, ood)
    train, test_iid, test_ood = _image_data(n_train, n_test)
    parts = jdist.node_datasets(train, n, ood_node=ood, q=0.10, seed=0)
    batcher = jpipe.NodeBatcher(parts, batch_size=32, steps_per_epoch=spe,
                                local_epochs=5)
    assert list(got["runs"]) == ["unweighted", "degree"]
    for strategy, res in got["runs"].items():
        want = _jax_ffn_run(topo, strategy, batcher, rounds, 5, 1, init,
                            test_iid, test_ood)
        assert _max_eval_drift(res["history"], want) <= EVAL_DRIFT_SAMPLES
        for which in ("iid", "ood"):
            assert res[f"{which}_auc"] == pytest.approx(
                jprop.accuracy_auc(want, which), abs=EVAL_DRIFT_SAMPLES / N_EVAL)
        assert res["map"].splitlines()[0] == jprop.render_propagation_map(
            want, topo.adjacency, ood).splitlines()[0]


def _reference_hierarchical_topology():
    """``hierarchical_topology`` and ``PER_POD`` as the reference script
    defines them, taken from its source with ``ast`` (the script trains
    at import, so it is not imported) and run with its own imports."""
    path = os.path.join(_ROOT, "examples", "multipod_hierarchy.py")
    tree = ast.parse(open(path).read())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef)
                and node.name == "hierarchical_topology")
            or (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "PER_POD"
                        for t in node.targets))]
    assert len(keep) == 2
    ns = {"np": np, "barabasi_albert": jtopo.barabasi_albert,
          "Topology": jtopo.Topology, "from_adjacency": jtopo.from_adjacency}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


@pytest.mark.parametrize("bridge", ["hub", "leaf"])
def test_hierarchical_topology_is_the_reference_s(bridge):
    """The two-pod graph equals the reference's function's exactly, and
    the pods are joined by one edge."""
    ref = _reference_hierarchical_topology()
    assert ref["PER_POD"] == tpod.PER_POD
    want = ref["hierarchical_topology"](bridge)
    got = tpod.hierarchical_topology(bridge)
    assert np.array_equal(got.adjacency, want.adjacency)
    assert got.name == want.name == f"2pod_bridge_{bridge}"
    assert len(tpod.bridge_edges(got)) == 1
    assert got.kth_highest_degree_node(2) == want.kth_highest_degree_node(2)


def test_two_pod_run_matches_the_reference_trainer():
    """``multipod_hierarchy.run`` at R = 2 (800 training images, 2 steps
    an epoch, E = 3) for both bridges against the script's steps on the
    JAX trainer: per-node accuracies, the global OOD AUC and the far
    pod's final OOD accuracy."""
    rounds, n_train, n_test, spe = 2, 800, 200, 2
    init, tinit = _ffn_init()
    got = tpod.run(rounds=rounds, n_train=n_train, n_test=n_test,
                   n_eval=N_EVAL, steps_per_epoch=spe, eval_every=1,
                   init=tinit, device="cpu")
    train, test_iid, test_ood = _image_data(n_train, n_test)
    ref = _reference_hierarchical_topology()
    for bridge in ("hub", "leaf"):
        topo = ref["hierarchical_topology"](bridge)
        ood = topo.kth_highest_degree_node(2)
        assert got[bridge]["ood_node"] == ood
        parts = jdist.node_datasets(train, topo.n_nodes, ood_node=ood,
                                    q=0.10, seed=0)
        nb = jpipe.NodeBatcher(parts, batch_size=32, steps_per_epoch=spe,
                               local_epochs=3)
        want = _jax_ffn_run(topo, "degree", nb, rounds, 3, 1, init,
                            test_iid, test_ood)
        assert _max_eval_drift(got[bridge]["history"], want) <= \
            EVAL_DRIFT_SAMPLES
        tol = EVAL_DRIFT_SAMPLES / N_EVAL
        assert got[bridge]["ood_auc"] == pytest.approx(
            jprop.accuracy_auc(want, "ood"), abs=tol)
        assert got[bridge]["far_pod_final_ood_acc"] == pytest.approx(
            float(np.asarray(want[-1].ood_acc)[tpod.PER_POD:].mean()),
            abs=tol)


# Measured (serve_per_node, N = 4, one round of 2 epochs × 2 steps, Adam
# 1e-3): trained params within 8.7e-5 of the reference's (Adam's first
# steps move a weight by about ±lr whatever the gradient's size, so a
# last-bit gradient difference on a near-zero entry becomes an update
# difference; ROADMAP Queue 3), the serve step's logits within 6.5e-6
# (|logits| ≤ 3.9), every greedy token equal, eval accuracies 0 samples
# apart.  Pinned: params 2e-4, logits 5e-5, tokens equal.
SERVE_PARAM_ATOL = 2e-4
SERVE_LOGIT_ATOL = 5e-5


def test_serve_per_node_matches_the_reference():
    """``serve_per_node.run`` at N = 4, one round (200 TinyMem training
    sequences, 2 steps an epoch) against the script's steps through the
    JAX package from the same init: the trained node-stacked params, the
    ``make_serve_step`` logits over ``make_cache(cfg, 4, 4, 32)`` and the
    two nodes' ``greedy_generate`` probes."""
    n, n_train, n_test, n_eval, spe = 4, 200, 50, 32, 2
    cfg = JConfig(name="tinymem-serve", n_layers=1, d_model=192, n_heads=6,
                  n_kv_heads=6, d_ff=768, vocab_size=16, mlp_kind="gelu",
                  norm_kind="layernorm", max_seq_len=160, dtype="float32",
                  param_dtype="float32")
    assert vars(cfg) == vars(tserve.serve_config())
    init = jax.tree.map(np.asarray, jax.jit(
        lambda k: jt.init_params(k, cfg))(jax.random.key(0)))
    got = tserve.run(n_nodes=n, rounds=1, n_train=n_train, n_test=n_test,
                     n_eval=n_eval, steps_per_epoch=spe, eval_every=1,
                     init=params_from_jax(init, "cpu"), device="cpu")

    topo = jtopo.barabasi_albert(n, 2, seed=0)
    ood = topo.kth_highest_degree_node(1)
    train = jsyn.make_tinymem_dataset(n_train, seed=0)
    test = jsyn.make_tinymem_dataset(n_test, seed=99)
    parts = jdist.node_datasets(train, n, ood_node=ood, q=0.30, seed=0)
    nb = jpipe.NodeBatcher(parts, batch_size=8, steps_per_epoch=spe,
                           local_epochs=2)
    tb = _jnp(jpipe.make_test_batch(test, n_eval))
    ob = _jnp(jpipe.make_test_batch(jbackdoor.backdoored_testset(test),
                                    n_eval, ood_mask=True))
    trainer = jdec.DecentralizedTrainer(
        topo, JStrategy("degree", tau=0.1), jopt.adam(1e-3),
        jm.lm_loss(cfg), jm.lm_accuracy(cfg),
        jdec.DecentralizedConfig(rounds=1, local_epochs=2, eval_every=1))
    params, hist = trainer.run(jdec.stack_params([_jnp(init)] * n),
                               lambda r: _jnp(nb.round_batches(r)), tb, ob)
    assert got["ood_node"] == ood
    drift = max(float(np.abs(getattr(a, k) - np.asarray(getattr(b, k))).max())
                * n_eval for a, b in zip(got["history"], hist)
                for k in ("iid_acc", "ood_acc"))
    assert drift <= 1
    jleaves, tleaves = jax.tree.leaves(params), tree_util.leaves(got["params"])
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= \
            SERVE_PARAM_ATOL

    cache = jss.make_cache(cfg, n, batch_per_node=4, max_seq=32)
    prompts = jnp.asarray(
        np.random.default_rng(0).integers(0, 10, size=(n, 4, 1)), jnp.int32)
    logits, cache = jax.jit(jss.make_serve_step(cfg))(params, prompts, cache)
    assert np.array_equal(got["prompts"].numpy(), np.asarray(prompts))
    assert tuple(got["logits"].shape) == (n, 4, 1, 16)
    assert float(np.abs(got["logits"].numpy() - np.asarray(logits)).max()) \
        <= SERVE_LOGIT_ATOL
    assert np.array_equal(got["cache"]["position"].numpy(),
                          np.asarray(cache["position"]))

    trigger = jnp.asarray([[1, 0, 0]], jnp.int32)
    nodes = jdec.unstack_params(params, n)
    probed = (ood, int(np.argmax([len(p) for p in parts])))
    assert sorted(got["probes"]) == sorted(set(probed))
    for node in probed:
        want = jss.greedy_generate(cfg, nodes[node], trigger, n_new=4)
        assert np.array_equal(got["probes"][node], np.asarray(want)), node


LLM_FIELDS = dict(name="llm-cut", family="dense", n_layers=2, d_model=64,
                  n_heads=8, n_kv_heads=4, d_ff=256, vocab_size=512,
                  mlp_kind="swiglu", dtype="float32", param_dtype="float32")
LLM_NODES, LLM_SEQ, LLM_BATCH = 3, 16, 2


def _reference_pairing(vocab, seq_len, batch, seed=0):
    """What the reference script feeds a step: it calls ``next`` on each
    node's stream once per key, so the step's tokens are one draw's and
    its labels the next draw's."""
    st = lm_token_stream(vocab, seq_len, batch, seed=seed)
    while True:
        yield {"tokens": next(st)["tokens"], "labels": next(st)["labels"]}


# Measured (2 steps, the second gossiping, n = 3): step losses within
# 4.8e-7 of the reference's (about 7.0 and 6.9), final params within
# 4.8e-7.
# Pinned as the train driver's parity test: losses 5e-6, params 2e-5.
LLM_LOSS_ATOL, LLM_PARAM_ATOL = 5e-6, 2e-5


def test_llm_steps_match_the_reference_on_its_pairing(monkeypatch):
    """``decentralized_llm_pretrain.run`` at the d-64 cut, n = 3, one round
    of 2 steps (the second gossiping), from the reference's init and fed
    the reference's pairing, against the script's loop through the JAX
    ``make_train_step`` (jitted, with and without gossip): each step's
    loss and the final node-stacked params."""
    jcfg = JConfig(**LLM_FIELDS)
    one = jax.tree.map(np.asarray, jax.jit(
        lambda k: jt.init_params(k, jcfg))(jax.random.key(0)))
    monkeypatch.setattr(tllm, "lm_token_stream", _reference_pairing)
    got = tllm.run(rounds=1, steps=2, nodes=LLM_NODES,
                   cfg=tllm.ModelConfig(**LLM_FIELDS), seq_len=LLM_SEQ,
                   batch=LLM_BATCH, init=params_from_jax(one, "cpu"),
                   device="cpu")

    pcfg = JParallel(n_nodes=LLM_NODES, microbatch=1, remat=False)
    coeffs = jnp.asarray(jmixing(jtopo.barabasi_albert(LLM_NODES, 2, seed=0),
                                 JStrategy("degree", tau=0.1)))
    opt = jopt.make_optimizer("adamw", 3e-4)
    fopts = jt.ForwardOptions(remat=False)
    gossip_step = jax.jit(jts.make_train_step(jcfg, pcfg, opt, opts=fopts))
    local_step = jax.jit(jts.make_train_step(jcfg, pcfg, opt, opts=fopts,
                                             gossip=False))
    params = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (LLM_NODES,) + x.shape).copy(), _jnp(one))
    opt_state = jax.vmap(opt.init)(params)
    streams = [lm_token_stream(jcfg.vocab_size, seq_len=LLM_SEQ,
                               batch=LLM_BATCH, seed=i)
               for i in range(LLM_NODES)]
    losses = []
    for s in range(2):
        batch = {k: jnp.stack([next(st)[k] for st in streams])[:, None]
                 for k in ("tokens", "labels")}
        fn = gossip_step if s == 1 else local_step
        params, opt_state, loss = fn(params, opt_state, batch, coeffs)
        losses.append(float(loss))
    assert np.abs(np.array(got["step_losses"]) - losses).max() <= \
        LLM_LOSS_ATOL
    assert got["round_losses"] == [float(np.mean(got["step_losses"]))]
    jleaves, tleaves = jax.tree.leaves(params), tree_util.leaves(got["params"])
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= LLM_PARAM_ATOL


def test_llm_example_pairs_tokens_and_labels_of_one_draw(monkeypatch):
    """Each step takes one draw from each node's stream: its labels are
    its tokens shifted by one, and after R rounds of S steps every stream
    has been drawn R·S times (the reference draws 2·R·S)."""
    draws = {}

    def counted(vocab, seq_len, batch, seed=0):
        draws[seed] = 0
        for d in lm_token_stream(vocab, seq_len, batch, seed=seed):
            draws[seed] += 1
            yield d

    seen = []
    real = tllm.step_batch

    def keep(streams, device):
        b = real(streams, device)
        seen.append(b)
        return b

    monkeypatch.setattr(tllm, "lm_token_stream", counted)
    monkeypatch.setattr(tllm, "step_batch", keep)
    tllm.run(rounds=2, steps=2, nodes=LLM_NODES,
             cfg=tllm.ModelConfig(**LLM_FIELDS), seq_len=LLM_SEQ,
             batch=LLM_BATCH, device="cpu")
    assert draws == {i: 4 for i in range(LLM_NODES)}
    assert len(seen) == 4
    for b in seen:
        assert tuple(b["tokens"].shape) == (LLM_NODES, 1, LLM_BATCH, LLM_SEQ)
        assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])


def test_llm_configs_state_their_parameter_counts():
    """The docstring's counts: ``param_count()`` 65,011,712 at
    ``--full100m`` and 8,126,464 by default; the tree (norm scales
    included) is the gossip plane's width."""
    assert tllm.model_config(True).param_count() == 65_011_712
    assert tllm.model_config(False).param_count() == 8_126_464
    assert "65,011,712" in tllm.__doc__ and "65,020,416" in tllm.__doc__
    # the tree's size from its shapes, without drawing 65 M values
    cfg = tllm.model_config(True)
    d, L = cfg.d_model, cfg.n_layers
    hd = d // cfg.n_heads
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + 3 * d * cfg.d_ff + 2 * d)
    assert 2 * cfg.vocab_size * d + d + L * per_layer == 65_020_416


def test_importing_the_examples_runs_nothing():
    """Each example module is import-safe: importing all four (in a fresh
    interpreter without a GPU) prints nothing and trains nothing."""
    code = textwrap.dedent("""
        import time
        t = time.perf_counter()
        import repro_torch.examples.quickstart
        import repro_torch.examples.multipod_hierarchy
        import repro_torch.examples.serve_per_node
        import repro_torch.examples.decentralized_llm_pretrain
        import repro_torch.benchmarks.perf_iterations
        assert time.perf_counter() - t < 30
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


def test_examples_run_on_the_card_by_default(monkeypatch):
    """``device=None`` is the CUDA card: without one, every example
    raises before it trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (tquick.run, tpod.run, tserve.run, tllm.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
