"""Port parity for the RWKV-6 family: the scan's plain version against the
JAX package's reference and its Pallas kernel (interpret mode), the
time-mix in both branches, the channel-mix, one ``ssm`` layer, ``forward``
with and without the scan kernel (its plain version on the CPU),
``init_cache`` and ``decode_step``, on parameters carried over from a JAX
init (``params_from_jax`` with the port's own init as the dtype skeleton)
and the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.kernels.ref import rwkv_scan_ref as jscan_ref
from repro.kernels.ssm_scan import rwkv_scan_pallas
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ssm_scan as tscan
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

# the SSM config of tests/test_serving.py
SSM = dict(name="ssm", family="ssm", n_layers=2, d_model=64, d_ff=128,
           vocab_size=64, rwkv_head_dim=32, norm_kind="layernorm",
           dtype="float32", param_dtype="float32")


def _configs(dtype="float32"):
    f = dict(SSM, dtype=dtype, param_dtype=dtype)
    return JConfig(**f), TConfig(**f)


_PARAMS = {}


def _params(jc, tc, seed=0):
    """JAX init (jitted) and the same weights in the port, each leaf in
    the dtype of the port's own init of the config."""
    key = (jc, seed)
    if key not in _PARAMS:
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(seed))
        like = tt.init_params(torch.Generator().manual_seed(0), tc)
        tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jp), "cpu", like=like)
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 64, size=shape).astype(
        np.int32)


def _scan_inputs(b, s, h, hd, seed=0):
    """tests/test_kernels.py's distribution, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, s, h, hd)) * 0.5 - 2))
    u = rng.normal(size=(h, hd)) * 0.3
    st = rng.normal(size=(b, h, hd, hd)) * 0.1
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u, st))


def _t(arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _layer0(tree, node_axis=True):
    """Layer 0 of the stacked layer leaves, with a node axis in the port."""
    if node_axis:
        return tree_util.tree_map(lambda a: a[0][None], tree)
    return jax.tree.map(lambda a: a[0], tree)


# ----------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (1, 64, 2, 16, 16), (2, 100, 2, 32, 32), (1, 128, 4, 32, 64),
    (1, 37, 1, 16, 32),
])
def test_scan_ref_matches_reference(b, s, h, hd, chunk):
    """The port's plain scan against the JAX reference (f32, the same
    sequential arithmetic: within 1e-5, measured at most 1.4e-6 at |y| up
    to 8.7) and the Pallas kernel in interpret mode (the chunked
    cumulative-product form: within 1e-4, measured at most 1.7e-6)."""
    arrs = _scan_inputs(b, s, h, hd)
    y, st = tscan.rwkv_scan_ref(*_t(arrs))
    assert y.dtype == torch.float32 and st.shape == (b, h, hd, hd)
    jy, jst = jscan_ref(*_j(arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                               atol=1e-5)
    py, pst = rwkv_scan_pallas(*_j(arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), rtol=0,
                               atol=1e-4)


def test_scan_state_threading_matches_two_calls():
    """scan(x₁∥x₂) == scan(x₂ | state=scan(x₁)), bit for bit (the same
    steps in the same order)."""
    r, k, v, w, u, st = _t(_scan_inputs(1, 64, 2, 16))
    y_full, s_full = tscan.rwkv_scan_ref(r, k, v, w, u, st)
    y1, s1 = tscan.rwkv_scan_ref(r[:, :32], k[:, :32], v[:, :32], w[:, :32],
                                 u, st)
    y2, s2 = tscan.rwkv_scan_ref(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:],
                                 u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(s2, s_full)


def test_scan_takes_one_bonus_per_sequence():
    """u ``(B, H, hd)`` (a fleet's per-node bonus, folded into the batch)
    equals one call per sequence with its own ``(H, hd)``, bit for bit."""
    r, k, v, w, _, st = _t(_scan_inputs(3, 20, 2, 16))
    u = torch.as_tensor(np.random.default_rng(5).normal(
        size=(3, 2, 16)).astype(np.float32))
    y, s = tscan.rwkv_scan_ref(r, k, v, w, u, st)
    for i in range(3):
        yi, si = tscan.rwkv_scan_ref(r[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     w[i:i + 1], u[i], st[i:i + 1])
        assert torch.equal(y[i:i + 1], yi) and torch.equal(s[i:i + 1], si)


def test_scan_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result
    (bf16 y for bf16 r, f32 state) and launches nothing; bad shapes and
    dtypes are refused."""
    r, k, v, w, u, st = _t(_scan_inputs(2, 9, 2, 16))
    rb, kb, vb = (x.to(torch.bfloat16) for x in (r, k, v))
    before = tscan.rwkv_scan.launches
    y, s = tscan.rwkv_scan(rb, kb, vb, w, u, st)
    yr, sr = tscan.rwkv_scan_ref(rb, kb, vb, w, u, st)
    assert tscan.rwkv_scan.launches == before
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, yr) and torch.equal(s, sr)
    with pytest.raises(ValueError, match="share one"):
        tscan.rwkv_scan(r, k[:, :5], v, w, u, st)
    with pytest.raises(ValueError, match="u must be"):
        tscan.rwkv_scan(r, k, v, w, u[:1], st)
    with pytest.raises(ValueError, match="state must be"):
        tscan.rwkv_scan(r, k, v, w, u, st[:1])
    with pytest.raises(TypeError, match="one dtype"):
        tscan.rwkv_scan(rb, k, v, w, u, st)


# ----------------------------------------------------------------------
# the blocks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_matches_reference(use_kernel):
    """One layer's time-mix from a nonzero state and token-shift carry:
    output within 1e-4 of the reference's (measured 1.7e-5 at |out| up to
    47), the final state within 2e-4 (measured 3.8e-5 at |S| up to 120)
    and the last x exactly."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    st = (rng.normal(size=(2, 2, 32, 32)) * 0.1).astype(np.float32)
    prev = rng.normal(size=(2, 64)).astype(np.float32)
    jout, jst, jlast = jssm.rwkv_time_mix(
        _layer0(jp["dense_layers"]["time_mix"], False), jc, jnp.asarray(x),
        jnp.asarray(st), jnp.asarray(prev), use_kernel=use_kernel)
    before = tscan.rwkv_scan.launches
    out, s, last = tssm.rwkv_time_mix(
        _layer0(tp["dense_layers"]["time_mix"]), tc,
        torch.as_tensor(x)[None], torch.as_tensor(st)[None],
        torch.as_tensor(prev)[None], use_kernel=use_kernel)
    assert tscan.rwkv_scan.launches == before    # CPU: the plain version
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(s[0].numpy(), np.asarray(jst), rtol=0,
                               atol=2e-4)
    np.testing.assert_array_equal(last[0].numpy(), np.asarray(jlast))


def test_time_mix_decode_matches_reference():
    """One token through ``rwkv_time_mix_decode`` from a carried state:
    within 5e-5 of the reference's (measured 8.1e-6 at |out| up to 29),
    the state within 2e-4 (measured 3.1e-5 at |S| up to 110), the new
    carry exactly."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    st = (rng.normal(size=(2, 2, 32, 32)) * 0.1).astype(np.float32)
    prev = rng.normal(size=(2, 64)).astype(np.float32)
    jout, jst, jlast = jssm.rwkv_time_mix_decode(
        _layer0(jp["dense_layers"]["time_mix"], False), jc, jnp.asarray(x),
        jnp.asarray(st), jnp.asarray(prev))
    out, s, last = tssm.rwkv_time_mix_decode(
        _layer0(tp["dense_layers"]["time_mix"]), tc,
        torch.as_tensor(x)[None], torch.as_tensor(st)[None],
        torch.as_tensor(prev)[None])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(s[0].numpy(), np.asarray(jst), rtol=0,
                               atol=2e-4)
    np.testing.assert_array_equal(last[0].numpy(), np.asarray(jlast))


def test_channel_mix_matches_reference():
    """Within 1e-6 (measured 3.0e-8 at |out| up to 1.9), the last x
    exactly."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    prev = rng.normal(size=(2, 64)).astype(np.float32)
    jout, jlast = jssm.rwkv_channel_mix(
        _layer0(jp["dense_layers"]["channel_mix"], False), jnp.asarray(x),
        jnp.asarray(prev))
    out, last = tssm.rwkv_channel_mix(
        _layer0(tp["dense_layers"]["channel_mix"]), torch.as_tensor(x)[None],
        torch.as_tensor(prev)[None])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(last[0].numpy(), np.asarray(jlast))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_layer_matches_reference(use_kernel):
    """One ``ssm`` layer of ``forward`` (norm, time-mix, norm,
    channel-mix) against the reference's layer function: within 2e-4
    (measured at most 4.6e-5 at |x| up to 50)."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    x = np.random.default_rng(9).normal(size=(2, 11, 64)).astype(np.float32)
    layer = jt._make_layer_fn(jc, False, jt.ForwardOptions(
        remat=False, use_ssm_kernel=use_kernel))
    jout, _ = layer(jnp.asarray(x), _layer0(jp["dense_layers"], False), 0,
                    jnp.arange(11))
    out, _ = tt._rwkv_layer(_layer0(tp["dense_layers"]), tc,
                            torch.as_tensor(x)[None],
                            tt.ForwardOptions(use_ssm_kernel=use_kernel))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), rtol=0,
                               atol=2e-4)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference_f32(use_kernel):
    """Logits within 1e-4 of the reference's (measured at most 2.2e-5 at
    |logit| up to 3.3: XLA's and torch's f32 exp/tanh differ in the last
    bits, and the recurrence carries the differences along)."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    toks = _tokens((2, 12))
    opts = dict(use_ssm_kernel=use_kernel)
    ref, _ = jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(**opts)))(jp,
                                                          jnp.asarray(toks))
    out, aux = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                          tt.ForwardOptions(**opts))
    assert out.shape == (2, 12, 64) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_forward_matches_reference_bf16():
    """The bf16 model with its f32 decay leaves, the scan through the
    kernel's plain version on one side and the Pallas kernel on the
    other: logits within 16 bf16 ulps of the largest logit (measured
    0.111 at |logit| up to 3.28, 7.1 ulps: each block agrees to one
    ulp, and the one-ulp rounding flips compound over the layers)."""
    jc, tc = _configs("bfloat16")
    jp, tp = _params(jc, tc)
    assert tp["dense_layers"]["time_mix"]["bonus_u"].dtype == torch.float32
    toks = _tokens((2, 12), seed=4)
    opts = dict(use_ssm_kernel=True)
    ref, _ = jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(**opts)))(jp,
                                                          jnp.asarray(toks))
    ref = np.asarray(ref, np.float32)
    out, _ = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                        tt.ForwardOptions(**opts))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert float(np.abs(out.numpy() - ref).max()) <= 16 * ulp


def test_init_cache_matches_reference():
    """The same leaves, shapes and dtypes: the RWKV state f32 and the
    token-shift carries in the activation dtype."""
    for dtype in ("float32", "bfloat16"):
        jc, tc = _configs(dtype)
        jcache = jt.init_cache(jc, 3, 16)
        tcache = tt.init_cache(tc, 3, 16, device="cpu")
        assert sorted(jcache) == sorted(tcache) == [
            "cm_prev", "position", "rwkv_state", "tm_prev"]
        for k in jcache:
            assert tuple(tcache[k].shape) == jcache[k].shape
            assert str(tcache[k].dtype)[6:] == str(jcache[k].dtype)
            assert float(tcache[k].float().abs().max()) == 0.0


def _decode_all_port(tc, tp, toks):
    cache = tt.init_cache(tc, toks.shape[0], 16, device="cpu")
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = tt.decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                       cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy(), cache


def test_decode_step_matches_reference():
    """12 cached decode steps: logits within 1e-4 of the reference's
    (measured 9.1e-6), the state leaves within 1e-3 (measured 2.2e-4 for
    the RWKV state, whose entries reach 181; 3.8e-6 for the carries) and
    the positions exactly."""
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    toks = _tokens((2, 12), seed=2)
    out, cache = _decode_all_port(tc, tp, toks)
    jcache = jt.init_cache(jc, 2, 16)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    ref = []
    for i in range(12):
        logits, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        ref.append(np.asarray(logits[:, 0]))
    np.testing.assert_allclose(out, np.stack(ref, 1), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(cache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in tt.SSM_STATE_LEAVES:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_forward(use_kernel):
    """The serving invariant of ``tests/test_serving.py``
    (``test_decode_matches_forward`` for ``SSM``): token-by-token cached
    decode reproduces the full-sequence forward's logits, within the
    reference's own 3e-3 and to 1e-5 (measured 0: the one-step body is
    the same arithmetic either way, and the kernel's plain version is too
    on the CPU)."""
    _, tc = _configs()
    _, tp = _params(*_configs())
    toks = _tokens((2, 12), seed=1)
    full = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                      tt.ForwardOptions(use_ssm_kernel=use_kernel))[0].numpy()
    inc, _ = _decode_all_port(tc, tp, toks)
    np.testing.assert_allclose(inc, full, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(inc, full, rtol=0, atol=1e-5)


def test_init_params_tree_matches_the_reference():
    """The port's own init draws the reference's tree for the bf16
    rwkv6-3b smoke config: the same leaves, shapes and dtypes (the two
    f32 leaves included)."""
    jc, tc = _configs("bfloat16")
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                            jax.random.key(0))
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        tp) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), shapes)


def test_params_from_jax_keeps_f32_leaves():
    """``like=`` carries a bf16 RWKV tree across without rounding its f32
    leaves (``decay_base``, ``bonus_u``: bit for bit), the bf16 leaves
    cast once; ``dtype=`` still casts every floating leaf; a shape
    mismatch and both arguments at once are refused."""
    jc, tc = _configs("bfloat16")
    jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(3))
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    like = tt.init_params(torch.Generator().manual_seed(0), tc)
    got = params_from_jax(np_tree, "cpu", like=like)
    tm = got["dense_layers"]["time_mix"]
    for name in ("decay_base", "bonus_u"):
        assert tm[name].dtype == torch.float32
        np.testing.assert_array_equal(
            tm[name].numpy(), np_tree["dense_layers"]["time_mix"][name])
    assert tm["wr"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tm["wr"].float().numpy(), np_tree["dense_layers"]["time_mix"]["wr"])
    cast = params_from_jax(np_tree, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree_util.leaves(cast))
    with pytest.raises(ValueError, match="not both"):
        params_from_jax(np_tree, "cpu", torch.bfloat16, like=like)
    small = dataclasses.replace(tc, d_model=32, rwkv_head_dim=16)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(np_tree, "cpu",
                        like=tt.init_params(torch.Generator(), small))
