"""Port parity for the f32 coefficient programs and the packed parameter
plane."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core import topology as jtopo
from repro.core.plane import PlaneLayout as JPlaneLayout
from repro.core.strategies import AggregationStrategy as JStrategy
from repro.models import paper_models as jmodels
from repro_torch.core import decentralized as tdec
from repro_torch.core import topology as ttopo
from repro_torch.core.coeffs import program_for
from repro_torch.core.plane import PlaneLayout as TPlaneLayout
from repro_torch.core.strategies import AggregationStrategy as TStrategy
from repro_torch.interop import params_from_jax, params_to_numpy

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["unweighted", "weighted", "fl", "degree"])
@pytest.mark.parametrize("n,p,seed,tau", [(8, 2, 0, 0.1), (16, 3, 2, 0.5),
                                          (33, 2, 0, 0.1)])
def test_coeffs_stack_matches_reference(kind, n, p, seed, tau):
    """Logits match bit for bit; f32 ``exp`` differs by one ulp between
    XLA and torch on some entries (12 of 1089 at n=33), and the row sum
    and divide carry that on.  Measured max: 1.19e-7 at a value of 0.88
    (two ulps there, n=33 degree); unweighted/weighted/fl are exact.
    Pinned: 1e-7 absolute plus one f32 ulp relative."""
    counts = np.random.default_rng(seed).integers(5, 50, n).astype(np.float64)
    ref = jdec.coeffs_stack(jtopo.barabasi_albert(n, p, seed),
                            JStrategy(kind, tau=tau), 3, data_counts=counts)
    port = tdec.coeffs_stack(ttopo.barabasi_albert(n, p, seed),
                             TStrategy(kind, tau=tau), 3, data_counts=counts)
    assert port.dtype == np.float32 and port.shape == ref.shape
    tol = dict(rtol=2.0 ** -23, atol=1e-7)
    if kind != "degree":
        tol = dict(rtol=0, atol=0)
    np.testing.assert_allclose(port, ref, **tol)
    np.testing.assert_allclose(
        tdec.round_coeffs(ttopo.barabasi_albert(n, p, seed),
                          TStrategy(kind, tau=tau), 2, data_counts=counts),
        ref[2], **tol)


@pytest.mark.parametrize("kind,kwargs", [
    ("random", {}), ("betweenness", {}), ("metropolis", {}),
    ("degree", {"p_fail": 0.1}), ("degree", {"reactive": True})])
def test_unported_programs_raise(kind, kwargs):
    """The port raises where the reference's ``program_for`` raises, with
    the same exception type: ``metropolis`` has no coefficient program
    (KeyError).  The cells that once raised for want of a port now build
    and equal the reference's matrices (to the degree kind's 1e-7 plus
    one ulp above)."""
    from repro.core.coeffs import program_for as jprogram_for

    jt, tt = jtopo.ring(5), ttopo.ring(5)
    try:
        jprog, jstate = jprogram_for(jt, JStrategy(kind), **kwargs)
    except Exception as exc:   # the reference's refusal
        with pytest.raises(type(exc)):
            program_for(tt, TStrategy(kind), **kwargs)
        assert kind == "metropolis"
        return
    prog, state = program_for(tt, TStrategy(kind), **kwargs)
    np.testing.assert_allclose(prog.materialize(state, 3),
                               jprog.materialize(jstate, 3),
                               rtol=2.0 ** -23, atol=1e-7)


def _jax_trees():
    # shapes only: the reference's init runs op by op (~20 s) outside jit
    return {
        "ffn": jax.eval_shape(lambda k: jmodels.ffn_init(k, hidden=16),
                              jax.random.key(0)),
        "vgg": jax.eval_shape(
            lambda k: jmodels.vgg_init(k, width_mult=0.125),
            jax.random.key(1)),
    }


@pytest.mark.parametrize("model", ["ffn", "vgg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_pack_unpack_matches_reference(model, dtype):
    """Same plane, column for column (jax.tree leaf order: sorted dict
    keys, VGG's pool marker leaves inside ``convs``)."""
    single = _jax_trees()[model]
    n = 3
    rng = np.random.default_rng(0)
    jstack = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=(n,) + x.shape), jnp.float32),
        single)
    np_stack = jax.tree.map(np.asarray, jstack)
    tstack = params_from_jax(np_stack, "cpu")
    jl, tl = JPlaneLayout.from_tree(jstack), TPlaneLayout.from_tree(tstack)
    assert jl.n_params == tl.n_params
    assert [s.offset for s in jl.slots] == [s.offset for s in tl.slots]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jplane = np.asarray(jl.pack(jstack, dtype=jdt).astype(jnp.float32))
    tplane = tl.pack(tstack, dtype=tdt)
    assert tplane.stride(0) * tplane.element_size() % 16 == 0
    assert np.array_equal(tplane.float().numpy(), jplane)
    back = params_to_numpy(tl.unpack(tplane))
    ref = jax.tree.map(np.asarray, jl.unpack(jl.pack(jstack, dtype=jdt)))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plane_rejects_other_trees():
    tree = {"a": torch.zeros(2, 3), "b": [torch.zeros(2), torch.zeros(2, 1)]}
    layout = TPlaneLayout.from_tree(tree)
    assert layout.n_params == 5
    with pytest.raises(ValueError, match="mismatch"):
        layout.pack({"a": torch.zeros(2, 3), "b": [torch.zeros(2)]})
    with pytest.raises(ValueError, match="columns"):
        layout.unpack(torch.zeros(2, 4))


def test_tree_helpers_and_plane_free_tensors_without_the_collector():
    """With the cyclic garbage collector off, a tree's tensors die as soon
    as the last tree holding them goes: flatten, unflatten, tree_map,
    leaves_with_paths, pack and unpack keep no reference (a self-calling
    nested function would, through its own closure, until a collection)."""
    import gc
    import weakref

    from repro_torch import tree as tree_util

    gc.disable()
    try:
        tree = {"a": torch.zeros(2, 3), "b": [torch.ones(2), None]}
        refs = [weakref.ref(t) for t in tree_util.leaves(tree)]
        stacked = tree_util.tree_map(lambda t: t + 1, tree)
        tree_util.leaves_with_paths(tree)
        layout = TPlaneLayout.from_tree(stacked)
        plane = layout.pack(stacked)
        views = layout.unpack(plane)
        plane_ref = weakref.ref(plane)
        stacked_refs = [weakref.ref(t) for t in tree_util.leaves(stacked)]
        del tree
        assert all(r() is None for r in refs)
        del stacked
        assert all(r() is None for r in stacked_refs)
        del plane, views
        assert plane_ref() is None
    finally:
        gc.enable()
