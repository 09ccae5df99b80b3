"""Port parity for the dense transformer stack: ``forward`` and
``decode_step`` of the port against the JAX package's on parameters
carried over from a JAX init (``params_from_jax``) and the same numpy
tokens, for the stablelm-1.6b and gemma2-27b smoke configs and every
attention implementation (``pallas`` runs the kernel's plain version on
the CPU, the JAX side its Pallas kernel in interpret mode)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.registry import get_smoke_config as jget
from repro.models import transformer as jt
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ARCHS = ("stablelm-1.6b", "gemma2-27b")


def _configs(arch, dtype="float32"):
    jc, tc = jget(arch), tget(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return (dataclasses.replace(jc, dtype=dtype, param_dtype=dtype),
            dataclasses.replace(tc, dtype=dtype, param_dtype=dtype))


_PARAMS = {}


def _params(jc, tc, seed=0):
    """JAX init (jitted) and the same weights in the port, on the CPU."""
    key = (jc, seed)
    if key not in _PARAMS:
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(seed))
        tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jp), "cpu", tc.weight_dtype)
        _PARAMS[key] = (jp, tp)
    return _PARAMS[key]


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(arch, impl):
    """f32 logits within 1e-5 (measured at most 3.1e-6, |logits| ≤ 4.5):
    the two frameworks sum in other orders."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks = _tokens(jc.vocab_size, (2, 64))
    ref = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(attn_impl=impl,
                                                remat=False))[0])(
        jp, jnp.asarray(toks)))
    out, aux = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                          tt.ForwardOptions(attn_impl=impl))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ("einsum", "pallas"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch, impl):
    """The bf16 configs (the dtype the chip runs): logits are bf16 values
    cast to f32 on both sides (the head's product rounds to bf16 before
    the cast, and gemma2 then caps them), so they agree to within four
    bf16 ulps of the largest logit (measured: 1 ulp for stablelm, 0.031
    at |logits| ≤ 4.5; 1.9 ulps for gemma2, 0.029 at ≤ 3.85)."""
    jc, tc = _configs(arch, "bfloat16")
    jp, tp = _params(jc, tc)
    toks = _tokens(jc.vocab_size, (2, 64))
    ref = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(attn_impl=impl,
                                                remat=False))[0])(
        jp, jnp.asarray(toks)))
    out = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                     tt.ForwardOptions(attn_impl=impl))[0].numpy()
    assert np.abs(out - ref).max() <= 4 * _bf16_ulp(np.abs(ref).max())


def test_forward_options_map_like_the_reference():
    assert tt.ForwardOptions().attn_impl == "einsum"
    assert tt.ForwardOptions(use_flash=True).attn_impl == "pallas"
    assert tt.ForwardOptions(attn_impl="chunked").attn_impl == "chunked"
    with pytest.raises(ValueError, match="attn_impl"):
        tt.ForwardOptions(attn_impl="flash")


def _decode_all_port(tc, tp, toks, max_seq):
    cache = tt.init_cache(tc, toks.shape[0], max_seq, device="cpu")
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = tt.decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                       cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy(), cache


def _decode_all_jax(jc, jp, toks, max_seq):
    cache = jt.init_cache(jc, toks.shape[0], max_seq)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = step(jp, jnp.asarray(toks[:, i:i + 1]), cache)
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, 1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """12 cached decode steps: logits within 1e-5 of the reference's
    (measured at most 2.2e-6), the caches to 1e-5 (measured 1.9e-6) and
    the positions exactly."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks = _tokens(jc.vocab_size, (2, 12), seed=2)
    out, cache = _decode_all_port(tc, tp, toks, 16)
    ref, jcache = _decode_all_jax(jc, jp, toks, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in ("k", "v"):
        assert cache[k].shape == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-5)


LOCAL = dict(name="local", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab_size=64, attn_pattern=("local", "global"),
             window_size=8, dtype="float32", param_dtype="float32")
ALL_LOCAL = dict(LOCAL, name="all-local", attn_pattern=("local",))
DENSE = dict(LOCAL, name="dense", attn_pattern=("global",))


@pytest.mark.parametrize("fields", [DENSE, LOCAL, ALL_LOCAL],
                         ids=lambda f: f["name"])
def test_decode_matches_forward(fields):
    """The serving invariant (``tests/test_serving.py``): token-by-token
    cached decode reproduces the full-sequence forward's logits, within
    the reference's own 3e-3 and to 1e-5 (measured: 0 for the dense and
    local configs, 1.7e-6 for the all-local one).  20 tokens past
    a window of 8: ``ALL_LOCAL`` caches only the window (T = 8), so its
    ring buffer wraps twice; ``LOCAL`` ring-indexes inside a uniform
    T = 24."""
    jc, tc = JConfig(**fields), TConfig(**fields)
    jp, tp = _params(jc, tc)
    toks = _tokens(64, (2, 20), seed=3)
    full = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)})[0].numpy()
    inc, cache = _decode_all_port(tc, tp, toks, 24)
    assert cache["k"].shape[2] == (8 if fields is ALL_LOCAL else 24)
    np.testing.assert_allclose(inc, full, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(inc, full, rtol=0, atol=1e-5)


def test_ring_buffer_wraps_like_the_reference():
    """The all-local ring cache after 20 tokens in a window of 8 holds the
    same K/V slots as the reference's (to 1e-5, measured 1.5e-6; logits
    2.2e-6)."""
    jc, tc = JConfig(**ALL_LOCAL), TConfig(**ALL_LOCAL)
    jp, tp = _params(jc, tc)
    toks = _tokens(64, (1, 20), seed=4)
    out, cache = _decode_all_port(tc, tp, toks, 24)
    ref, jcache = _decode_all_jax(jc, jp, toks, 24)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=1e-5)


def test_unported_families_raise():
    """The three configs the port once refused (the hybrid family and
    the two modality frontends) now raise nowhere: each smoke config's
    port init has the reference's tree, and from the reference's weights
    its forward (tokens for hymba, the frontends' embeddings for the
    others) and 4 decode steps on tokens match the reference's logits
    within 1e-5 (measured at most 2.1e-6).  Their own files hold the
    rest: ``tests/test_torch_hybrid.py``,
    ``tests/test_torch_frontends.py``."""
    for arch in ("hymba-1.5b", "musicgen-medium", "internvl2-1b"):
        jc, tc = jget(arch), tget(arch)
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(0))
        like = tt.init_params(torch.Generator().manual_seed(0), tc)
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                            jp) == jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype)[6:]), like)
        tp = params_from_jax(jax.tree.map(lambda a: np.asarray(
            a, np.float32), jp), "cpu", like=like)
        if jc.frontend is None:
            x = _tokens(jc.vocab_size, (2, 12), seed=3)
            jb, tb = {"tokens": jnp.asarray(x)}, {"tokens": torch.as_tensor(x)}
        else:
            x = np.random.default_rng(3).standard_normal(
                (2, 12, jc.frontend_dim)).astype(np.float32)
            jb = {"embeddings": jnp.asarray(x)}
            tb = {"embeddings": torch.as_tensor(x)}
        ref = np.asarray(jax.jit(lambda p, b: jt.forward(p, jc, b)[0])(jp, jb))
        np.testing.assert_allclose(tt.forward(tp, tc, tb)[0].numpy(), ref,
                                   rtol=0, atol=1e-5)
        toks = _tokens(jc.vocab_size, (2, 4), seed=4)
        ref, _ = _decode_all_jax(jc, jp, toks, 8)
        out, _ = _decode_all_port(tc, tp, toks, 8)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_init_params_tree_matches_the_reference():
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (its numbers come from torch's stream; a torch
    tensor is a leaf to ``jax.tree``).  The MoE configs add
    ``moe_layers`` (llama4-scout without ``dense_layers``) and keep the
    router f32 in a bf16 tree."""
    for arch in ARCHS + ("deepseek-v2-236b", "llama4-scout-17b-a16e"):
        jc, tc = _configs(arch, "bfloat16")
        shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                                jax.random.key(0))
        tp = tt.init_params(torch.Generator().manual_seed(0), tc)
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                            tp) == jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), shapes)
        if tc.is_moe:
            assert tp["moe_layers"]["moe"]["router"].dtype == torch.float32
            assert ("dense_layers" in tp) == (tc.first_k_dense > 0)


def test_param_count_of_the_two_chip_configs():
    """stablelm-1.6b at full width and depth, gemma2-27b at full width cut
    to its first local and global layer (what ``chip_smoke.py`` runs)."""
    from repro_torch.configs.registry import get_config

    assert get_config("stablelm-1.6b").param_count() == 1_644_167_168
    g2 = dataclasses.replace(get_config("gemma2-27b"), n_layers=2)
    assert g2.param_count() == 3_491_758_080
    assert g2.layer_kinds() == ("local", "global")
