"""Port parity for the paper's third model, GPT-2 on TinyMem, and the LM
training step, on the CPU against the JAX package.

* At GPT-2-TinyMem's full width (one layer, d 768, 12 heads, d_ff 3072,
  vocab 16; P = 7,107,072): ``lm_loss``, ``lm_accuracy`` and the loss's
  gradients on weights carried over from a jitted JAX init
  (``params_from_jax``, one node and stacked).
* At a narrow width (d 64): ``softmax_xent``, ``lm_loss_fn`` full and
  chunked, the three learning-rate schedules, ``adamw`` and
  ``make_optimizer`` over several steps, ``make_train_step`` (microbatch 1
  and 2, with and without gossip) and ``reshape_for_microbatch``, each
  against a live reference run.
* The node slices that ``working_bytes`` sizes.

Algorithm 1 and the sweep engine on TinyMem are
``tests/test_torch_lm_sweep.py``'s.

Each tolerance is stated beside the value measured here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import ParallelConfig as JParallel
from repro.data import backdoor as jbd
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import paper_models as jm
from repro.models import transformer as jt
from repro.training import losses as jloss
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import ParallelConfig as TParallel
from repro_torch.core import decentralized as tdec
from repro_torch.interop import params_from_jax
from repro_torch.models import paper_models as tm
from repro_torch.models import transformer as tt
from repro_torch.training import losses as tloss
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

torch.set_num_threads(2)

NARROW = dict(name="gpt2_narrow", family="dense", n_layers=1, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=16,
              mlp_kind="gelu", norm_kind="layernorm", max_seq_len=160,
              dtype="float32", param_dtype="float32")


def _narrow(layers=1):
    return (JConfig(**{**NARROW, "n_layers": layers}),
            TConfig(**{**NARROW, "n_layers": layers}))


_INITS = {}


def _init(jc, seed=0):
    """A jitted JAX init of ``jc`` and the same weights in the port."""
    key = (jc, seed)
    if key not in _INITS:
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(seed))
        np_tree = jax.tree.map(np.asarray, jp)
        _INITS[key] = (jp, np_tree, params_from_jax(np_tree, "cpu"))
    return _INITS[key]


def _torch(tree):
    return tree_util.tree_map(torch.as_tensor, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(a, b) -> float:
    """max |a − b| over max |b| (b the reference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _lm_batches(rows=8, seed=9999):
    """An IID TinyMem batch and an OOD batch of triggered rows (backdoored,
    with the trigger mask), ``(rows, 150)`` each."""
    test = jsyn.make_dataset("tinymem", 400, seed=seed)
    iid = jpipe.make_test_batch(test, rows, seed=0)
    toks, _, has = jbd.apply_language_backdoor(test.x)
    ood_toks = toks[has][:rows]
    return iid, {"tokens": ood_toks,
                 "mask": jbd.language_backdoor_mask(ood_toks)}


# ----------------------------------------------------------------------
# GPT-2-TinyMem at full width
# ----------------------------------------------------------------------
def test_gpt2_tinymem_config_and_weights_carry_over():
    """The configs agree field by field; the JAX tree carries over leaf
    for leaf, one node and stacked, with the port's own init's shapes;
    7,107,072 parameters a node."""
    jc, tc = jm.gpt2_tinymem_config(), tm.gpt2_tinymem_config()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.n_layers, tc.d_model, tc.n_heads, tc.d_ff, tc.vocab_size) \
        == (1, 768, 12, 3072, 16)
    jp, np_tree, tp = _init(jc)
    own = tt.init_params(torch.Generator().manual_seed(0), tc)
    assert [tuple(a.shape) for a in tree_util.leaves(tp)] == \
        [tuple(a.shape) for a in tree_util.leaves(own)]
    assert sum(a.numel() for a in tree_util.leaves(tp)) == 7_107_072
    for a, b in zip(tree_util.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    stacked = params_from_jax(
        jax.tree.map(lambda a: np.stack([a, 2 * a]), np_tree), "cpu")
    for a, b in zip(tree_util.leaves(stacked), jax.tree.leaves(jp)):
        assert tuple(a.shape) == (2,) + b.shape
        assert np.array_equal(a[1].numpy(), 2 * np.asarray(b))


@pytest.mark.parametrize("which", ["iid", "ood"])
def test_lm_loss_accuracy_and_gradients_full_width(which):
    """Measured: loss 9.5e-7 apart (|loss| 3.31), accuracy equal, each
    gradient leaf within 7.9e-7 of the largest reference gradient entry
    (1.03).  Pinned: loss 5e-6 absolute, accuracy exact, gradients 1e-5
    relative to max |ref|."""
    jc, tc = jm.gpt2_tinymem_config(), tm.gpt2_tinymem_config()
    jp, _, tp = _init(jc)
    batch = dict(zip(("iid", "ood"), _lm_batches()))[which]
    jb, tb = _jnp(batch), _torch(batch)
    if which == "ood":
        assert batch["mask"].sum() > 0
    jl = float(jax.jit(jm.lm_loss(jc))(jp, jb))
    tl = float(tm.lm_loss(tc)(tp, tb))
    assert abs(tl - jl) <= 5e-6, (tl, jl)
    assert float(tm.lm_accuracy(tc)(tp, tb)) == \
        float(jax.jit(jm.lm_accuracy(jc))(jp, jb))
    jg = jax.jit(jax.grad(jm.lm_loss(jc)))(jp, jb)
    tg = torch.func.grad(tm.lm_loss(tc))(tp, tb)
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(jg))
    for a, b in zip(tree_util.leaves(tg), jax.tree.leaves(jg)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) \
            <= 1e-5 * scale


def test_lm_working_bytes_size_the_node_slices():
    """``working_bytes`` of ``lm_accuracy`` counts three f32 ``(b, H, S,
    S)`` score tensors and the rows' activations: at FULL's eval batch
    (512 × 150) 5.45 GB a node, so half of an 80 GB card evaluates 7
    nodes a call.  ``lm_loss``'s counts a gradient step's saved
    activations twice: 0.99 GB a node at (32, 150), so a grid of two
    experiments of 33 nodes takes its gradients 40 nodes a call (33, one
    whole experiment, when it is folded into the node axis) and one run
    of 33 nodes in one call.  The classifiers state none: one call."""
    cfg = tm.gpt2_tinymem_config()
    acc, loss = tm.lm_accuracy(cfg), tm.lm_loss(cfg)
    b = {"tokens": np.zeros((512, 150), np.int32)}
    assert acc.working_bytes(b) == tm.lm_eval_bytes(cfg, b) == \
        4 * 512 * 150 * (3 * 12 * 150 + 8 * 768 + 2 * 3072 + 3 * 16)
    half = 80 * 10 ** 9 // 2
    assert tdec.slice_rows(acc, b, 33, half) == 7
    assert tdec.slice_rows(acc, b, 33, None) == 33
    step = {"tokens": np.zeros((32, 150), np.int32)}
    assert loss.working_bytes(step) == tm.lm_train_bytes(cfg, step) == \
        2 * 4 * 32 * 150 * (2 * 12 * 150 + 4 * 3072 + 13 * 768)
    assert tdec.slice_rows(loss, step, 66, half) == 40
    assert tdec.slice_rows(loss, step, 66, half, 33) == 33
    assert tdec.slice_rows(loss, step, 66, 70 * 10 ** 9, 33) == 66
    assert tdec.slice_rows(loss, step, 66, 20 * 10 ** 9, 33) == 20
    assert tdec.slice_rows(loss, step, 33, half) == 33
    for fn in (tm.classifier_accuracy(tm.ffn_apply),
               tm.classifier_loss(tm.ffn_apply)):
        assert tdec.slice_rows(fn, b, 33, 1) == 33
    assert tdec.node_budget("cpu") is None


# ----------------------------------------------------------------------
# losses (narrow)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_softmax_xent_matches_reference(z_loss):
    """Measured: 9.5e-7 apart (values 6.7–12.1: one f32 ulp).  Pinned
    2e-6."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 20, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 20)).astype(np.int32)
    j = float(jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                 z_loss))
    t = float(tloss.softmax_xent(torch.as_tensor(logits),
                                 torch.as_tensor(labels), z_loss))
    assert abs(t - j) <= 2e-6, (t, j)


@pytest.mark.parametrize("chunk", [0, 8, 16, 40])
@pytest.mark.parametrize("layers", [1, 2])
def test_lm_loss_fn_full_and_chunked(chunk, layers):
    """``lm_loss_fn`` on ``{tokens, labels}``, full (chunk 0) and
    sequence-chunked (S = 40: chunks of 16 drop the last 8 positions, as
    the reference's do).  Measured: ≤ 2.4e-7 apart (|loss| ≈ 3.3), the
    gradients within 3.7e-7 of max |ref|.  Pinned: 5e-6 absolute, 1e-5
    relative."""
    jc, tc = _narrow(layers)
    jp, _, tp = _init(jc)
    batch = next(jpipe.lm_token_stream(16, 40, 3, seed=layers))
    jl = jax.jit(jax.value_and_grad(jloss.lm_loss_fn(jc, chunked_ce=chunk)))
    (jv, jg) = jl(jp, _jnp(batch))
    tg, tv = torch.func.grad_and_value(tloss.lm_loss_fn(
        tc, chunked_ce=chunk))(tp, _torch(batch))
    assert abs(float(tv) - float(jv)) <= 5e-6
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(jg))
    for a, b in zip(tree_util.leaves(tg), jax.tree.leaves(jg)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) \
            <= 1e-5 * scale


# ----------------------------------------------------------------------
# schedules and optimizers (narrow)
# ----------------------------------------------------------------------
SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(3e-3)),
    "cosine": (lambda m: m.cosine_schedule(1e-3, 10, 0.1)),
    "cosine_frac0": (lambda m: m.cosine_schedule(2e-2, 7, 0.0)),
    "warmup_cosine": (lambda m: m.warmup_cosine_schedule(1e-3, 3, 12)),
    "warmup_only": (lambda m: m.warmup_cosine_schedule(5e-4, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Each schedule over steps 0..total+2 on an int32 step vector, as the
    optimizer's per-node counter feeds it.  Measured: equal but for one
    step of the two cosine schedules, 2.9e-8 relative (torch's and XLA's
    f32 cos round apart).  Pinned: 2.4e-7 relative (two ulps)."""
    jf, tf = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    steps = np.arange(0, 17, dtype=np.int32)
    ref = np.array([float(jf(jnp.asarray(s, jnp.int32))) for s in steps],
                   np.float32)
    got = tf(torch.as_tensor(steps))
    got = np.full(steps.shape, got, np.float32) if isinstance(got, float) \
        else got.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=0)


def _opt_tree(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 5, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((n, 7)).astype(np.float32)}}


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(1e-2)),
    "adamw_sched": (lambda m: m.adamw(m.warmup_cosine_schedule(1e-2, 2, 6),
                                      weight_decay=0.05, clip_norm=1.0)),
    "adam_sched": (lambda m: m.adam(m.cosine_schedule(3e-3, 5))),
    "sgd_sched": (lambda m: m.sgd(m.cosine_schedule(0.1, 4), momentum=0.9)),
    "make_adamw_guard": (lambda m: m.make_optimizer(
        "adamw", m.warmup_cosine_schedule(1e-2, 2, 6), skip_nonfinite=True)),
    "make_sgd": (lambda m: m.make_optimizer("sgd", 0.05)),
    "make_adam": (lambda m: m.make_optimizer("adam", 1e-3, b2=0.99)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference_over_steps(name):
    """Eight steps on seeded gradients (a NaN in node 1's gradient at step
    3 for the guarded optimizer), the reference's update vmapped over the
    node axis.  Measured: params within 9.7e-9 of max |ref| after eight
    steps (updates within 2.5e-7: the schedules' f32 cos and Adam's m/√v
    round apart in the last bit), the step and skip counters equal.
    Pinned: 2e-6 relative, counters exact."""
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    params = _opt_tree()
    jp, tp = _jnp(params), _torch(params)
    js, ts = jax.vmap(jo.init)(jp), to.init(tp)
    for step in range(8):
        g = _opt_tree(seed=100 + step)
        if name == "make_adamw_guard" and step == 3:
            g["a"][1, 0, 0] = np.nan
        ju, js = jax.vmap(jo.update)(_jnp(g), js, jp)
        jp = jax.vmap(jopt.apply_updates)(jp, ju)
        tu, ts = to.update(_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for a, b in zip(tree_util.leaves(tp), jax.tree.leaves(jp)):
        assert _rel(a.numpy(), b) <= 2e-6
    if name == "make_adamw_guard":
        assert np.array_equal(ts["skipped"].numpy(), np.asarray(js.skipped))
        assert ts["skipped"].tolist() == [0, 1, 0]
        ts, js = ts["inner"], js.inner
    assert np.array_equal(ts["step"].numpy(), np.asarray(js.step))


def test_make_optimizer_refuses_an_unknown_name_and_adamw_needs_params():
    with pytest.raises(KeyError, match="unknown optimizer"):
        topt.make_optimizer("lion", 1e-3)
    opt = topt.adamw(1e-3)
    tree = _torch(_opt_tree())
    with pytest.raises(ValueError, match="requires params"):
        opt.update(tree, opt.init(tree), None)


# ----------------------------------------------------------------------
# the production train step (narrow)
# ----------------------------------------------------------------------
def test_reshape_for_microbatch_matches_reference():
    batch = next(jpipe.lm_token_stream(16, 12, 8, seed=0))
    for n, micro in ((2, 2), (4, 1), (1, 4)):
        t = tts.reshape_for_microbatch(_torch(batch), n, micro)
        j = jts.reshape_for_microbatch(_jnp(batch), n, micro)
        for k in batch:
            assert np.array_equal(t[k].numpy(), np.asarray(j[k]))
            assert tuple(t[k].shape) == (n, micro, 8 // n // micro, 12)
    with pytest.raises(ValueError, match="not divisible"):
        tts.reshape_for_microbatch(_torch(batch), 2, 3)


TRAIN_STEP_OPTS = {
    # (optimizer, params' pin): SGD's update is linear in the gradient, so
    # the params keep the gradients' f32 agreement.  Adam's first steps
    # move each entry by about ±eta whatever the gradient's size, so an
    # entry whose gradient is rounding noise moves by up to eta apart:
    # that pin is absolute, a tenth of the peak rate 1e-3.
    "sgd": (lambda m: m.sgd(m.cosine_schedule(0.05, 10), momentum=0.9),
            dict(rtol=1e-5)),
    "adamw": (lambda m: m.adamw(m.warmup_cosine_schedule(1e-3, 2, 10)),
              dict(atol=1e-4)),
}


@pytest.mark.parametrize("opt_name", sorted(TRAIN_STEP_OPTS))
@pytest.mark.parametrize("gossip", [False, True])
@pytest.mark.parametrize("micro", [1, 2])
def test_make_train_step_matches_reference(micro, gossip, opt_name):
    """Three steps of ``make_train_step`` at n = 4, batches from
    ``lm_token_stream``, gossip by a ring's matrix (1/3 each).  Measured:
    losses within 2.4e-7; after three steps, SGD's params within
    4.8e-7 of max |ref|, AdamW's within 4.4e-5 absolute (first
    step; no growth after).  Pinned: loss 5e-6 absolute, params as
    ``TRAIN_STEP_OPTS`` says."""
    n = 4
    jc, tc = _narrow()
    _, np_tree, _ = _init(jc)
    stack = lambda t: jax.tree.map(lambda a: np.stack([a] * n), t)
    jpar = _jnp(stack(np_tree))
    tpar = params_from_jax(stack(np_tree), "cpu")
    jpc, tpc = (JParallel(n_nodes=n, microbatch=micro),
                TParallel(n_nodes=n, microbatch=micro))
    make, pin = TRAIN_STEP_OPTS[opt_name]
    jo, to = make(jopt), make(topt)
    jstep = jax.jit(jts.make_train_step(jc, jpc, jo, gossip=gossip))
    tstep = tts.make_train_step(tc, tpc, to, gossip=gossip)
    coeffs = np.full((n, n), 0.0, np.float32)
    for i in range(n):
        for j in (i - 1, i, i + 1):
            coeffs[i, j % n] = 1.0 / 3
    jst, tst = jax.vmap(jo.init)(jpar), to.init(tpar)
    stream = jpipe.lm_token_stream(16, 24, n * micro * 2, seed=micro)
    for _ in range(3):
        batch = next(stream)
        jpar, jst, jl = jstep(jpar, jst, jts.reshape_for_microbatch(
            _jnp(batch), n, micro), jnp.asarray(coeffs))
        tpar, tst, tl = tstep(tpar, tst, tts.reshape_for_microbatch(
            _torch(batch), n, micro), torch.as_tensor(coeffs))
        assert np.isfinite(float(tl))
        assert abs(float(tl) - float(jl)) <= 5e-6
    for a, b in zip(tree_util.leaves(tpar), jax.tree.leaves(jpar)):
        if "rtol" in pin:
            assert _rel(a.numpy(), b) <= pin["rtol"]
        else:
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) \
                <= pin["atol"]
