"""Port parity for the hybrid family (hymba-1.5b: Mamba heads beside
attention): the Mamba block's init, conv, scan and decode, and the hymba
smoke config's forward, decode, generator, train step and fleet serving
against the JAX package on parameters carried over from a JAX init
(``params_from_jax``), the same numpy inputs and requests.  The
admission reset of the Mamba state (a re-used slot serves as a fresh one
does; the reference carries the previous request's ``ssm_state`` and
``conv_state`` over, which a test records) and the f32 plane the three
f32 leaf kinds make."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.registry import get_config as jfull
from repro.configs.registry import get_smoke_config as jget
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.serving import scheduler as jsched
from repro.serving import serve_step as jss
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import tree as tree_util
from repro_torch.configs.base import ParallelConfig as TParallel
from repro_torch.configs.registry import get_config as tfull
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.core.plane import PlaneLayout
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import serve_step as tss
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
# per node, the reference's tree at full size (jax.eval_shape of its init)
HYMBA_PARAMS = 1_641_681_600
HYMBA_F32_PARAMS = 1_843_200     # dt_bias, log_a, d_skip over 32 layers


def _configs(dtype="float32", **kw):
    jc, tc = jget(ARCH), tget(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return (dataclasses.replace(jc, dtype=dtype, param_dtype=dtype, **kw),
            dataclasses.replace(tc, dtype=dtype, param_dtype=dtype, **kw))


_PARAMS = {}


def _params(jc, tc, seed=0):
    """JAX init (jitted) and the same weights in the port, each leaf in
    the port's own init's dtype (the three f32 leaf kinds stay f32)."""
    key = (jc, seed)
    if key not in _PARAMS:
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(seed))
        like = tt.init_params(torch.Generator().manual_seed(0), tc)
        _PARAMS[key] = jp, params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu",
            like=like)
    return _PARAMS[key]


def _fleet(jc, tc, seeds):
    jps, tps = zip(*(_params(jc, tc, s) for s in seeds))
    return (jax.tree.map(lambda *xs: jnp.stack(xs), *jps),
            tree_util.tree_map(lambda *xs: torch.stack(xs), *tps))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


# ----------------------------------------------------------------------
# the Mamba block
# ----------------------------------------------------------------------
def _mamba(jc, tc, n=2):
    """n nodes' Mamba weights: the reference's ``mamba_init`` (jitted) of
    keys 0..n-1, and the same weights node-stacked in the port."""
    dtype = jc.weight_dtype
    jps = [jax.jit(lambda k: jssm.mamba_init(k, jc, dtype))(
        jax.random.key(s)) for s in range(n)]
    like = tssm.mamba_init(torch.Generator().manual_seed(0), tc,
                           tc.weight_dtype, 1)
    tp = tree_util.tree_map(
        lambda *xs: torch.cat(xs),
        *[params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                       [None], p), "cpu", like=like)
          for p in jps])
    return jps, tp


def _inputs(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.as_tensor(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_init_tree_and_deterministic_leaves(dtype):
    """``mamba_init`` draws the reference's tree: the same leaves, shapes
    and dtypes (``dt_bias``, ``log_a`` and ``d_skip`` f32 in a bf16
    model), and its deterministic leaves equal the reference's jitted
    init bit for bit: ``dt_bias`` zeros, ``d_skip`` ones and ``log_a``
    ``log(1..n)`` broadcast over ``di``, at the smoke config's n = 8 and
    hymba-1.5b's n = 16 (di = 3200)."""
    for jc, tc in (_configs(dtype), (jfull(ARCH), tfull(ARCH))):
        jc = dataclasses.replace(jc, dtype=dtype, param_dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype, param_dtype=dtype)
        jp = jax.jit(lambda k: jssm.mamba_init(k, jc, jc.weight_dtype))(
            jax.random.key(0))
        tp = tssm.mamba_init(torch.Generator().manual_seed(0), tc,
                             tc.weight_dtype, 3)
        assert jax.tree.map(lambda t: ((3,) + tuple(t.shape), str(t.dtype)),
                            jp) == jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
        for name in ("dt_bias", "log_a", "d_skip"):
            assert tp[name].dtype == torch.float32
            for layer in range(3):
                assert np.array_equal(tp[name][layer].numpy(),
                                      np.asarray(jp[name])), name
        assert float(tp["dt_bias"].abs().max()) == 0.0
        assert bool((tp["d_skip"] == 1).all())


# The Mamba block against the reference, per dtype.  f32 to the sums'
# order (measured: conv 1.8e-7 at |out| up to 2.2; apply and decode
# 4.2e-7 at |out| up to 0.81; ssm_state 4.8e-7 at |h| up to 0.83; the
# conv state, the last inputs of the in-projection, 1.4e-6 at 3.3).
# bf16 values are compared in bf16 ulps of the largest value, where XLA
# on the CPU computes an elementwise chain in f32 and rounds once and
# torch rounds each op (measured: conv 0, apply and decode 2 ulps, the
# conv state 0.0002 ulps); the f32 ssm_state of a bf16 block takes bf16
# inputs one rounding apart (measured 5.8e-3 at |h| up to 0.83)
MAMBA_TOLS = {"float32": {"conv": 1e-6, "out": 2e-6, "state": 2e-6,
                          "conv_state": 4e-6},
              "bfloat16": {"conv": 2, "out": 4, "state": 2e-2,
                           "conv_state": 1}}


def _close(got, want, tol, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol if dtype == "float32" or what == "state" \
        else tol * float(_bf16_ulp(np.abs(want).max()))
    assert err <= bound, (what, dtype, err, bound)
    return err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_conv_matches_reference(dtype):
    """The depthwise causal conv of two nodes, from zeros and from a
    carried conv state: the output and the next state per node against
    the reference's ``_mamba_conv`` (tolerances in ``MAMBA_TOLS``)."""
    jc, tc = _configs(dtype)
    jps, tp = _mamba(jc, tc)
    di = jc.ssm_expand * jc.d_model
    jx, tx = _inputs((2, 3, 9, di), dtype, 1)
    jst, tst = _inputs((2, 3, jc.ssm_conv_dim - 1, di), dtype, 2)
    tol = MAMBA_TOLS[dtype]["conv"]
    for state in (False, True):
        out, new = tssm._mamba_conv(tp, tx, tst if state else None)
        for i, jp in enumerate(jps):
            jout, jnew = jax.jit(jssm._mamba_conv)(
                jp, jx[i], jst[i] if state else None)
            _close(out[i], jout, tol, dtype, "conv")
            assert np.array_equal(_np(new[i]), _np(jnew))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(dtype):
    """``mamba_apply`` of two nodes over 9 tokens, from zero states and
    from carried ones: the output, the f32 ``ssm_state`` and the conv
    state per node against the reference's (``MAMBA_TOLS``)."""
    jc, tc = _configs(dtype)
    jps, tp = _mamba(jc, tc)
    di, n = jc.ssm_expand * jc.d_model, jc.ssm_state_dim
    jx, tx = _inputs((2, 3, 9, jc.d_model), dtype, 3)
    jh, th = _inputs((2, 3, di, n), "float32", 4)
    jcv, tcv = _inputs((2, 3, jc.ssm_conv_dim - 1, di), dtype, 5)
    tols = MAMBA_TOLS[dtype]
    for carried in (False, True):
        args = (th, tcv) if carried else ()
        out, (h, cv) = tssm.mamba_apply(tp, tc, tx, *args)
        assert h.dtype == torch.float32 and cv.dtype == tx.dtype
        for i, jp in enumerate(jps):
            jargs = (jh[i], jcv[i]) if carried else ()
            jout, (jh_new, jcv_new) = jax.jit(
                lambda p, x, *a: jssm.mamba_apply(p, jc, x, *a))(
                jp, jx[i], *jargs)
            _close(out[i], jout, tols["out"], dtype, "out")
            _close(h[i], jh_new, tols["state"], dtype, "state")
            _close(cv[i], jcv_new, tols["conv_state"], dtype, "conv_state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype):
    """Six ``mamba_decode`` steps of two nodes from zero states, each
    against the reference's step on its own carried states
    (``MAMBA_TOLS``)."""
    jc, tc = _configs(dtype)
    jps, tp = _mamba(jc, tc)
    jx, tx = _inputs((2, 3, 6, jc.d_model), dtype, 6)
    di, n, k = jc.ssm_expand * jc.d_model, jc.ssm_state_dim, jc.ssm_conv_dim
    th = torch.zeros((2, 3, di, n))
    tcv = torch.zeros((2, 3, k - 1, di), dtype=tx.dtype)
    jstates = [(jnp.zeros((3, di, n), jnp.float32),
                jnp.zeros((3, k - 1, di), jx.dtype)) for _ in jps]
    jstep = jax.jit(lambda p, x, h, c: jssm.mamba_decode(p, jc, x, h, c))
    tols = MAMBA_TOLS[dtype]
    for t in range(6):
        out, (th, tcv) = tssm.mamba_decode(tp, tc, tx[:, :, t:t + 1], th, tcv)
        for i, jp in enumerate(jps):
            jout, jstates[i] = jstep(jp, jx[i, :, t:t + 1], *jstates[i])
            _close(out[i], jout, tols["out"], dtype, "out")
            _close(th[i], jstates[i][0], tols["state"], dtype, "state")


def test_mamba_decoded_token_by_token_equals_apply():
    """A sequence of 11 tokens decoded one at a time (states threaded)
    equals ``mamba_apply`` over the whole sequence: outputs within 1e-6
    and the states within 1e-6 (measured 6.0e-8 for the outputs, whose
    last product sums one step at a time, and 0 for the states)."""
    jc, tc = _configs()
    _, tp = _mamba(jc, tc)
    _, tx = _inputs((2, 3, 11, tc.d_model), "float32", 7)
    full, (h_full, cv_full) = tssm.mamba_apply(tp, tc, tx)
    state, outs = (None, None), []
    for t in range(11):
        out, state = tssm.mamba_decode(tp, tc, tx[:, :, t:t + 1], *state) \
            if t else tssm.mamba_apply(tp, tc, tx[:, :, :1])
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), full.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(state[0].numpy(), h_full.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(state[1], cv_full)


# ----------------------------------------------------------------------
# the hymba smoke config end to end
# ----------------------------------------------------------------------
def test_init_params_tree_matches_the_reference():
    """The hymba smoke config's whole tree (each layer's ``mamba`` beside
    ``attn`` and ``mlp``) and hymba-1.5b's at full size
    (``jax.eval_shape``, no draw; the port's draws stubbed to empty
    tensors): the same leaves, shapes and dtypes, 1,641,681,600
    parameters a node of which 1,843,200 f32."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jfull(ARCH)),
                            jax.random.key(0))
    meta = tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                              device="meta"), shapes)
    leaves = tree_util.leaves(meta)
    assert sum(t.numel() for t in leaves) == HYMBA_PARAMS
    assert sum(t.numel() for t in leaves
               if t.dtype == torch.float32) == HYMBA_F32_PARAMS
    assert tfull(ARCH).param_count() == jfull(ARCH).param_count()


def test_hymba_plane_is_f32_and_each_step_casts_the_bf16_leaves():
    """Under the widest-dtype rule the three f32 leaf kinds make hymba's
    plane f32: 1,641,681,600 columns a node, 6.57 GB a node, 26.3 GB for
    the n = 4 fleet of ``chip_smoke.py``; ``unpack`` hands the f32
    leaves out as views and casts every bf16 leaf (1,639,838,400
    parameters, 3.28 GB a node), which each plane-fed decode step pays
    (ROADMAP Queue 1 [serving] (b)).  The layout is built on the meta
    device from the reference's full-size tree; the casts are checked on
    the bf16 smoke config."""
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jfull(ARCH)),
                            jax.random.key(0))
    stacked = tree_util.tree_map(
        lambda s: torch.empty((4,) + tuple(s.shape),
                              dtype=getattr(torch, str(s.dtype)),
                              device="meta"), shapes)
    layout = PlaneLayout.from_tree(stacked)
    assert layout.widest_dtype == torch.float32
    assert layout.n_params == HYMBA_PARAMS
    assert layout.plane_nbytes() == 4 * HYMBA_PARAMS * 4 == 26_266_905_600
    bf16 = sum(s.size for s in layout.slots if s.dtype == torch.bfloat16)
    assert bf16 == HYMBA_PARAMS - HYMBA_F32_PARAMS == 1_639_838_400
    jc, tc = _configs("bfloat16")
    _, tstack = _fleet(jc, tc, (0, 1))
    small = PlaneLayout.from_tree(tstack)
    plane = small.pack(tstack)
    assert plane.dtype == torch.float32
    for (path, t), s in zip(tree_util.leaves_with_paths(small.unpack(plane)),
                            small.slots):
        shares = t.untyped_storage().data_ptr() == \
            plane.untyped_storage().data_ptr()
        assert shares == (s.dtype == torch.float32), path


@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
def test_forward_matches_reference_f32(impl):
    """The f32 smoke config's logits (2 × 40 tokens, past the window of
    16) within 1e-5 (measured at most 3.8e-6 at |logits| ≤ 3.6) for
    every attention implementation."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size,
                                             (2, 40)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(attn_impl=impl,
                                                remat=False))[0])(
        jp, jnp.asarray(toks)))
    out, aux = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                          tt.ForwardOptions(attn_impl=impl))
    assert float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_forward_matches_reference_bf16():
    """The bf16 config (hymba-1.5b's dtype, its three f32 leaf kinds
    kept f32): logits are bf16 values cast to f32 on both sides, within
    four bf16 ulps of the largest logit (measured 2 ulps, 0.031 at
    |logits| ≤ 3.6)."""
    jc, tc = _configs("bfloat16")
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size,
                                             (2, 40)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(remat=False))[0])(
        jp, jnp.asarray(toks)))
    out = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)})[0].numpy()
    assert np.abs(out - ref).max() <= 4 * _bf16_ulp(np.abs(ref).max())


def _decode_port(tc, tp, toks, max_seq):
    cache = tt.init_cache(tc, toks.shape[0], max_seq, device="cpu")
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = tt.decode_step(tp, tc,
                                       torch.as_tensor(toks[:, i:i + 1]),
                                       cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy(), cache


def test_decode_step_matches_reference():
    """20 cached decode steps (past the window of 16): logits within 1e-5
    of the reference's (measured at most 2.4e-6), K/V, the Mamba state
    and the conv inputs to 1e-5 (measured 2.1e-6, 3.6e-7 and 2.0e-6) and
    the positions exactly; the cache holds the reference's leaves, shapes
    and dtypes."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size,
                                             (2, 20)).astype(np.int32)
    out, cache = _decode_port(tc, tp, toks, 24)
    jcache = jt.init_cache(jc, 2, 24)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    ref = []
    for i in range(20):
        logits, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        ref.append(np.asarray(logits[:, 0]))
    np.testing.assert_allclose(out, np.stack(ref, 1), rtol=0, atol=1e-5)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        assert str(cache[k].dtype)[6:] == str(jcache[k].dtype), k
    np.testing.assert_array_equal(cache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in ("k", "v", "ssm_state"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache["conv_state"].numpy(),
                               np.asarray(jcache["conv_state"]), rtol=0,
                               atol=1e-5)


def test_decode_matches_forward():
    """The serving invariant: token-by-token cached decode reproduces the
    full-sequence forward's logits to 1e-5 (measured 1.7e-6), Mamba state
    and attention ring included."""
    jc, tc = _configs()
    _, tp = _params(jc, tc)
    toks = np.random.default_rng(3).integers(0, tc.vocab_size,
                                             (2, 24)).astype(np.int32)
    full = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)})[0].numpy()
    inc, _ = _decode_port(tc, tp, toks, 24)
    np.testing.assert_allclose(inc, full, rtol=0, atol=1e-5)


def test_greedy_generate_matches_reference():
    """The single-node generator, greedy and at temperature 0.8 with a
    key: the reference's tokens exactly."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    prompt = np.array([[3, 17, 42, 5], [9, 1, 60, 2]], np.int32)
    want = np.asarray(jss.greedy_generate(jc, jp, jnp.asarray(prompt), 8))
    got = tss.greedy_generate(tc, tp, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    from repro_torch.core import prng

    for seed in (0, 5):
        want = np.asarray(jss.greedy_generate(
            jc, jp, jnp.asarray(prompt), 8, temperature=0.8,
            rng=jax.random.PRNGKey(seed)))
        got = tss.greedy_generate(tc, tp, torch.as_tensor(prompt), 8,
                                  temperature=0.8, rng=prng.key(seed))
        np.testing.assert_array_equal(got.numpy(), want)


def test_make_train_step_matches_reference():
    """One ``make_train_step`` step (SGD 0.1, no gossip; Adam's first step
    would turn last-bit gradient differences into whole-lr ones) on the
    f32 smoke config at n = 2 nodes (distinct inits), 2 microbatches of
    2 × 12 tokens a node: the loss within 1e-5 and every param within
    2e-7 (measured at most 6.7e-8, the embedding), the Mamba leaves
    included, each of which moves."""
    jc, tc = _configs()
    n, micro = 2, 2
    jpar, tpar = _fleet(jc, tc, (0, 1))
    jpc, tpc = (JParallel(n_nodes=n, microbatch=micro),
                TParallel(n_nodes=n, microbatch=micro))
    jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    jstep = jax.jit(jts.make_train_step(jc, jpc, jo, gossip=False))
    tstep = tts.make_train_step(tc, tpc, to, gossip=False)
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, size=(n * micro * 2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = jts.reshape_for_microbatch(jax.tree.map(jnp.asarray, batch), n,
                                    micro)
    tb = tts.reshape_for_microbatch(
        tree_util.tree_map(torch.as_tensor, batch), n, micro)
    jnew, _, jl = jstep(jpar, jax.vmap(jo.init)(jpar), jb,
                        jnp.eye(n, dtype=jnp.float32))
    tnew, _, tl = tstep(tpar, to.init(tpar), tb, torch.eye(n))
    assert abs(float(tl) - float(jl)) <= 1e-5, (float(tl), float(jl))
    moved = set()
    for (path, a), b, old in zip(tree_util.leaves_with_paths(tnew),
                                 jax.tree.leaves(jnew),
                                 jax.tree.leaves(jpar)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= 2e-7, (path, err)
        if "mamba" in path and float(np.abs(np.asarray(b)
                                            - np.asarray(old)).max()) > 0:
            moved.add(path[-1])
    assert moved == {"w_in", "conv_w", "w_bcdt", "dt_bias", "log_a",
                     "d_skip", "w_out"}


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _workload(seed, n, vocab=128):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(1, 14))).tolist(),
             int(rng.integers(1, 9))) for _ in range(n)]


def _serve(mod, cfg, stacked, n, n_slots, work, max_seq=32, **kw):
    fleet = mod.FleetScheduler(cfg, stacked, n_nodes=n, n_slots=n_slots,
                               max_seq=max_seq, **kw)
    reqs = [mod.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for i, r in enumerate(reqs):
        fleet.submit(r, node=i % n)
    steps = fleet.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], steps


def test_fleet_scheduler_matches_reference_on_first_admissions():
    """Every request takes a slot no request held before (3 per node, 3
    slots, chunked prefill of 8 with self-feeding lanes): the port's
    FleetScheduler emits the JAX one's tokens, in as many fleet steps."""
    jc, tc = _configs()
    jstack, tstack = _fleet(jc, tc, (0, 3))
    work = _workload(5, 6)
    want, jsteps = _serve(jsched, jc, jstack, 2, 3, work)
    got, steps = _serve(tsched, tc, tstack, 2, 3, work)
    assert got == want and steps == jsteps


def test_fleet_prefill_freezes_the_mamba_state_of_idle_lanes():
    """A chunked prefill call with lanes of 5, 3 and 0 tokens: each lane's
    ``ssm_state``, ``conv_state`` and ``position`` equal the reference's
    (within 1e-5, measured 3.3e-7 and 1.9e-6), and the idle lane's are its
    carried values bit for bit."""
    jc, tc = _configs()
    jstack, tstack = _fleet(jc, tc, (0, 3))
    from repro.core.plane import PlaneLayout as JLayout

    jlay, tlay = JLayout.from_tree(jstack), PlaneLayout.from_tree(tstack)
    toks = np.random.default_rng(4).integers(0, 128, (2, 3, 5)).astype(
        np.int32)
    lens = np.array([[5, 3, 0], [5, 5, 3]], np.int32)
    jcache = jss.make_cache(jc, 2, 3, 16)
    tcache = tss.make_cache(tc, 2, 3, 16, device="cpu")
    tcache["ssm_state"].normal_(generator=torch.Generator().manual_seed(0))
    tcache["conv_state"].normal_(generator=torch.Generator().manual_seed(1))
    jcache = dict(jcache, ssm_state=jnp.asarray(tcache["ssm_state"].numpy()),
                  conv_state=jnp.asarray(tcache["conv_state"].numpy()))
    before = {k: tcache[k].clone() for k in ("ssm_state", "conv_state")}
    _, _, jnew = jax.jit(jss.make_fleet_prefill_step(jc, jlay))(
        jlay.pack(jstack), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(lens), jcache)
    _, _, tnew = tss.make_fleet_prefill_step(tc, tlay)(
        tlay.pack(tstack), torch.as_tensor(toks), torch.as_tensor(lens),
        torch.as_tensor(lens), tcache)
    np.testing.assert_array_equal(tnew["position"].numpy(),
                                  np.asarray(jnew["position"]))
    for k in ("ssm_state", "conv_state"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-5)
        assert torch.equal(tnew[k][0, :, 2], before[k][0, :, 2]), k
        assert not torch.equal(tnew[k][0, :, 0], before[k][0, :, 0]), k


def _greedy(tc, tp, prompt, n_new):
    out = tss.greedy_generate(tc, tp, torch.tensor([prompt]), n_new,
                              max_seq=32)
    return out[0, len(prompt):].tolist()


def test_fleet_scheduler_reused_slots_equal_fresh_decode():
    """Two nodes with their own params, two slots each, five requests per
    node: every re-used slot serves exactly what ``greedy_generate`` gives
    the request's prompt on its node; the loop mode agrees."""
    jc, tc = _configs()
    _, tstack = _fleet(jc, tc, (0, 3))
    work = _workload(11, 10)
    got, _ = _serve(tsched, tc, tstack, 2, 2, work)
    for i, ((prompt, m), out) in enumerate(zip(work, got)):
        assert out == _greedy(tc, _params(jc, tc, (0, 3)[i % 2])[1],
                              prompt, m), i
    loop, _ = _serve(tsched, tc, tstack, 2, 2, work, vmapped=False)
    assert loop == got


# ROADMAP Queue 3's hybrid case: init key 0, two 6-token prompts, one slot
STALE_PROMPTS = np.random.default_rng(0).integers(0, 128,
                                                  size=(2, 6)).tolist()


def _admitted_state(mod, cfg, params):
    """One slot serves the first prompt; the second is then admitted into
    it.  Returns the largest |entry| of the slot's ``ssm_state`` and
    ``conv_state`` just after that admission, and both outputs."""
    sched = mod.NodeScheduler(cfg, params, n_slots=1, max_seq=16,
                              prefill_chunk=4)
    reqs = [mod.Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(STALE_PROMPTS)]
    sched.submit(reqs[0])
    sched.run_until_drained()
    sched.submit(reqs[1])
    sched._admit()
    carried = {k: float(np.abs(_np(sched.cache[k])).max())
               for k in tt.MAMBA_STATE_LEAVES}
    sched.run_until_drained()
    return carried, [r.output for r in reqs]


def test_reference_carries_stale_mamba_state_into_a_reused_slot():
    """The divergence, stated: the JAX NodeScheduler resets only
    ``position`` on admission, so its second request starts from the
    first one's ``ssm_state`` and ``conv_state`` (nonzero after the
    admission); the port's scheduler zeroes both, and serves both
    requests as fresh decodes of their prompts do.  At this init the
    carried state does not flip a token of the reference's second
    request (the state decays by ``exp(Δ·A)`` each step, the conv inputs
    leave after ``kdim − 1``), so the record is the state itself."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    fresh = [np.asarray(jss.greedy_generate(
        jc, jp, jnp.asarray([p], jnp.int32), 5))[0, 6:].tolist()
        for p in STALE_PROMPTS]
    assert [_greedy(tc, tp, p, 5) for p in STALE_PROMPTS] == fresh
    carried, ref = _admitted_state(jsched, jc, jp)
    assert min(carried.values()) > 0.1, carried
    assert ref[0] == fresh[0]
    carried, got = _admitted_state(tsched, tc, tp)
    assert carried == {"ssm_state": 0.0, "conv_state": 0.0}
    assert got == fresh


def test_admission_zeroes_the_mamba_state():
    """``reset_slots`` zeroes position and the hybrid family's
    ``ssm_state`` ``(N, L, B, di, n)`` and ``conv_state`` ``(N, L, B,
    kdim − 1, di)`` of the fresh slots only, in every layer; K/V are
    left alone."""
    assert set(tt.STATE_LEAVES) >= {"ssm_state", "conv_state"}
    cache = {"position": torch.full((2, 3), 7, dtype=torch.int32),
             "ssm_state": torch.ones((2, 2, 3, 6, 4)),
             "conv_state": torch.ones((2, 2, 3, 3, 6), dtype=torch.bfloat16),
             "k": torch.ones((2, 2, 3, 6, 1, 4))}
    fresh = torch.tensor([[True, False, False], [False, False, True]])
    out = tss.reset_slots(cache, fresh)
    assert out["position"].tolist() == [[0, 7, 7], [7, 7, 0]]
    for k in ("ssm_state", "conv_state"):
        assert out[k].dtype == cache[k].dtype
        assert float(out[k][0, :, 0].abs().max()) == 0.0
        assert float(out[k][1, :, 2].abs().max()) == 0.0
        assert bool((out[k][0, :, 1:] == 1).all())
        assert bool((out[k][1, :, :2] == 1).all())
    assert out["k"] is cache["k"]


def test_serve_cli_hybrid_smoke_on_cpu(capsys):
    """``--arch hymba-1.5b --smoke --layers 2 --device cpu`` serves every
    request, and ``--loop`` (the per-node loop) gives the same tokens."""
    args = ["--arch", ARCH, "--smoke", "--layers", "2", "--nodes", "2",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "5",
            "--device", "cpu"]
    fleet = tserve.main(args)
    loop = tserve.main(args + ["--loop"])
    assert len(fleet) == 4
    assert all(r.done and len(r.output) == 5 for r in fleet)
    assert [r.output for r in fleet] == [r.output for r in loop]
    out = capsys.readouterr().out
    assert "fleet plane" in out and "per-node loop" in out
