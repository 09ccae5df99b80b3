"""Port parity for the paper models, the optimizers and one full round of
Algorithm 1, on parameters carried over from a JAX init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import topology as jtopo
from repro.models import paper_models as jm
from repro.training import optimizer as jopt
from repro_torch.core import decentralized as tdec
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import paper_models as tm
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)


def _vgg_init(seed):
    # jitted: the reference's init runs op by op (~20 s) outside jit
    return jax.jit(lambda k: jm.vgg_init(k, width_mult=0.125))(
        jax.random.key(seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(port, ref, rtol, atol=0.0):
    port, ref = params_to_numpy(port), _np(ref)
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_ffn_forward_matches_reference():
    params = jax.jit(jm.ffn_init)(jax.random.key(0))
    x = np.random.default_rng(0).random((16, 28, 28, 1), dtype=np.float32)
    ref = np.asarray(jm.ffn_apply(params, jnp.asarray(x)))
    out = tm.ffn_apply(params_from_jax(_np(params), "cpu"),
                       torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_vgg_forward_matches_reference():
    """HWIO/NHWC at the public functions; NCHW inside for the library."""
    params = _vgg_init(1)
    x = np.random.default_rng(1).random((4, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jm.vgg_apply)(params, jnp.asarray(x)))
    out = tm.vgg_apply(params_from_jax(_np(params), "cpu"),
                       torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    y = np.array([0, 3, 9, 3], np.int32)
    for jf, tf in ((jm.classifier_loss, tm.classifier_loss),
                   (jm.classifier_accuracy, tm.classifier_accuracy)):
        r = float(jax.jit(jf(jm.vgg_apply))(
            params, {"x": jnp.asarray(x), "y": jnp.asarray(y)}))
        o = float(tf(tm.vgg_apply)(params_from_jax(_np(params), "cpu"),
                                   {"x": torch.as_tensor(x),
                                    "y": torch.as_tensor(y)}))
        assert o == pytest.approx(r, rel=1e-5)


def test_port_inits_have_the_reference_structure():
    g = torch.Generator().manual_seed(0)
    for port, ref in (
            (tm.ffn_init(g), jax.eval_shape(jm.ffn_init, jax.random.key(0))),
            (tm.vgg_init(g, width_mult=0.125),
             jax.eval_shape(lambda k: jm.vgg_init(k, width_mult=0.125),
                            jax.random.key(0)))):
        port = params_to_numpy(port)
        assert jax.tree.structure(port) == jax.tree.structure(ref)
        assert [a.shape for a in jax.tree.leaves(port)] == \
            [b.shape for b in jax.tree.leaves(ref)]


def test_global_norm_is_per_node():
    """Under the reference's vmap the clip norm is one per node."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "b": [rng.normal(size=(3, 2)).astype(np.float32) * 10]}
    ref_tree, ref_norm = jax.vmap(
        lambda t: jopt.clip_by_global_norm(t, 1.5))(
            jax.tree.map(jnp.asarray, tree))
    out_tree, out_norm = topt.clip_by_global_norm(
        params_from_jax(tree, "cpu"), 1.5)
    np.testing.assert_allclose(out_norm.numpy(), np.asarray(ref_norm),
                               rtol=1e-6)
    _assert_trees_close(out_tree, ref_tree, rtol=1e-6)


OPTS = {
    "sgd": (lambda m: m.sgd(1e-2)),
    "sgd_mom_clip": (lambda m: m.sgd(5e-2, momentum=0.9, clip_norm=0.5)),
    "adam": (lambda m: m.adam(1e-3)),
}


@pytest.mark.parametrize("mix_impl,opt,epoch_shuffle", [
    ("einsum", "sgd", True), ("pallas", "sgd", True), ("edges", "sgd", True),
    ("pallas", "sgd_mom_clip", True), ("edges", "adam", True),
    ("einsum", "adam", False)])
def test_one_round_matches_reference(mix_impl, opt, epoch_shuffle):
    n, steps, batch, epochs = 4, 2, 8, 2
    topo = jtopo.barabasi_albert(n, 2, 0)
    support = topo.adjacency + np.eye(n)
    coeffs = np.array(
        jdec.coeffs_stack(topo, jdec.AggregationStrategy("degree"), 1)[0])
    rng = np.random.default_rng(0)
    total = steps * (epochs if epoch_shuffle else 1)
    batches = {"x": rng.random((n, total, batch, 28, 28, 1), dtype=np.float32),
               "y": rng.integers(0, 10, (n, total, batch)).astype(np.int32)}
    init = jax.jit(lambda k: jm.ffn_init(k, hidden=32))(jax.random.key(3))
    jparams = jdec.stack_params([init] * n)
    jo = OPTS[opt](jopt)
    jround = jdec.make_round_fn(jm.classifier_loss(jm.ffn_apply), jo, epochs,
                                mix_impl, epoch_shuffle, mix_support=support)
    jp, _, jl = jround(jparams, jax.vmap(jo.init)(jparams),
                       jax.tree.map(jnp.asarray, batches), jnp.asarray(coeffs))
    to = OPTS[opt](topt)
    tparams = params_from_jax(_np(jparams), "cpu")
    tround = tdec.make_round_fn(tm.classifier_loss(tm.ffn_apply), to, epochs,
                                mix_impl, epoch_shuffle, mix_support=support,
                                device="cpu")
    tp, _, tl = tround(tparams, to.init(tparams),
                       params_from_jax(batches, "cpu"), torch.as_tensor(coeffs))
    # Adam's m/√v turns last-bit gradient differences on coordinates whose
    # gradient is ~0 into update differences bounded by lr: measured
    # 5.2e-6 on 6 of 100352 params (lr 1e-3) — pinned at 1e-5 for Adam
    _assert_trees_close(tp, jp, rtol=1e-5, atol=1e-5 if opt == "adam" else 1e-7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
