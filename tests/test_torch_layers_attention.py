"""``attention_apply`` and ``attention_decode`` (``repro_torch.models.layers``)
against the reference's (``repro/models/layers.py``) on the CPU.

The port's functions take node-stacked weights and ``(N, B, ...)``
activations; a single node is ``N = 1``.  The attention weights of each
smoke config come from the reference's ``attention_init``
(``params_from_jax``): stablelm-1.6b (plain GQA), gemma2-27b (window 16,
logit softcap 50; local and global layers) and llama4-scout
(``qk_norm``).  ``use_flash=True``
runs the flash kernel's plain version on the CPU (the reference: its
Pallas kernel in interpret mode); the kernel itself is held to that plain
version on the card (``chip_smoke.py`` phases 2 and 21).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jget
from repro.models import layers as jl
from repro_torch import tree as tree_util
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tl

torch.set_num_threads(2)

B, S, T = 2, 32, 24
CASES = [("stablelm-1.6b", "global"), ("gemma2-27b", "local"),
         ("gemma2-27b", "global"), ("llama4-scout-17b-a16e", "global")]
# Measured over CASES: attention_apply within 2.6e-7·max|ref| of the
# reference (3.8e-6 at |out| ≤ 15.2) with and without flash,
# attention_decode's output within 4.1e-7·max|ref|; the new value cache
# equal, the new key cache within 4.8e-7 (|k| ≤ 3.9: the written key is
# roped, and f32 cos/sin differ in the last ulp between torch and XLA).
# Pinned: outputs 1e-6·max|ref|, the key cache 1e-6.
REL_TOL, K_ATOL = 1e-6, 1e-6


@functools.lru_cache(maxsize=None)
def _layer0_attn(arch):
    """One layer's reference attention weights (numpy, f32, from the
    reference's ``attention_init``; drawn once an arch) and the port's
    node-stacked copy."""
    cfg = jget(arch)
    attn = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jl.attention_init(jax.random.key(0), cfg,
                                          jnp.float32))
    port = tree_util.tree_map(lambda t: t.unsqueeze(0),
                              params_from_jax(attn, "cpu"))
    return cfg, tget(arch), attn, port


def _x(d, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch,kind", CASES)
def test_attention_apply_matches_reference(arch, kind, use_flash):
    jcfg, tcfg, attn, port = _layer0_attn(arch)
    x = _x(jcfg.d_model, (B, S), 0)
    want = np.asarray(jl.attention_apply(
        jax.tree.map(jnp.asarray, attn), jcfg, jnp.asarray(x),
        jnp.arange(S), kind, use_flash))
    got = tl.attention_apply(port, tcfg, torch.as_tensor(x)[None],
                             torch.arange(S), kind, use_flash)
    assert tuple(got.shape) == (1,) + want.shape
    assert float(np.abs(got[0].numpy() - want).max()) <= \
        REL_TOL * float(np.abs(want).max())


@pytest.mark.parametrize("arch,kind", CASES)
def test_attention_decode_matches_reference(arch, kind):
    """One token at positions inside the cache (and, for a local layer's
    ring buffer, past its T slots): the output and both new caches."""
    jcfg, tcfg, attn, port = _layer0_attn(arch)
    kv, hd = jcfg.n_kv_heads, jcfg.head_dim_
    rng = np.random.default_rng(1)
    cache_k, cache_v = (rng.standard_normal((B, T, kv, hd)).astype(np.float32)
                        for _ in range(2))
    x = _x(jcfg.d_model, (B, 1), 2)
    positions = [np.array([0, 7], np.int32), np.array([T - 1, 3], np.int32)]
    if kind == "local":
        positions.append(np.array([T + 5, 2 * T + 1], np.int32))
    for pos in positions:
        want = jl.attention_decode(
            jax.tree.map(jnp.asarray, attn), jcfg, jnp.asarray(x),
            jnp.asarray(cache_k), jnp.asarray(cache_v), jnp.asarray(pos),
            kind)
        got = tl.attention_decode(
            port, tcfg, torch.as_tensor(x)[None],
            torch.as_tensor(cache_k)[None], torch.as_tensor(cache_v)[None],
            torch.as_tensor(pos)[None], kind)
        out, new_k, new_v = (g[0].numpy() for g in got)
        ref = np.asarray(want[0])
        assert float(np.abs(out - ref).max()) <= \
            REL_TOL * float(np.abs(ref).max()), pos
        assert float(np.abs(new_k - np.asarray(want[1])).max()) <= K_ATOL
        np.testing.assert_array_equal(new_v, np.asarray(want[2]))
