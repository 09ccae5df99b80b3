"""Port parity for flash attention: the port's plain version
``flash_attention_ref`` (what ``flash_attention`` runs on CPU tensors)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)


def _inputs(b, s, h, kv, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def _assert_close(port, other, bf16=False):
    """|port − other| ≤ 2e-5·max|other| elementwise (the card gate for
    f32: another summation order), plus one bf16 ulp of ``other`` for
    bf16 outputs (each side rounds its own f32 value once)."""
    tol = 2e-5 * np.abs(other).max()
    if bf16:
        tol = tol + 2.0 ** (np.floor(np.log2(
            np.maximum(np.abs(other), 2.0 ** -126))) - 7)
    assert np.all(np.abs(port - other) <= tol), \
        float(np.abs(port - other).max())


def _run(q, k, v, dtype, **kw):
    """(port, JAX Pallas interpret, JAX oracle) outputs as f32 numpy."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    tq, tk, tv = (torch.as_tensor(x).to(dtype) for x in (q, k, v))
    port = tfa.flash_attention(tq, tk, tv, **kw)
    assert port.dtype == dtype and port.shape == tq.shape
    pallas = flash_attention_pallas(jq, jk, jv, bq=32, bkv=32, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    return (port.float().numpy(), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 128, 4, 2, 32),   # GQA
    (2, 100, 4, 4, 32),   # ragged S (the Pallas wrapper pads it)
    (1, 64, 6, 1, 16),    # MQA
])
def test_causal_matches_reference(b, s, h, kv, hd):
    """f32 (measured: at most 3.2e-7·max|out| from the Pallas kernel and
    2.2e-7·max|out| from the oracle)."""
    port, pallas, oracle = _run(*_inputs(b, s, h, kv, hd, s), torch.float32)
    _assert_close(port, pallas)
    _assert_close(port, oracle)


@pytest.mark.parametrize("window", [16, 64])
def test_sliding_window_matches_reference(window):
    """Measured: at most 2.9e-7·max|out| from either."""
    port, pallas, oracle = _run(*_inputs(1, 128, 4, 2, 32, window),
                                torch.float32, window=window)
    _assert_close(port, pallas)
    _assert_close(port, oracle)


def test_softcap_and_window_ragged_matches_reference():
    """softcap 20 with window 16 on a ragged S, inputs ×3 so the cap
    bites (measured: at most 9.8e-7·max|out| from either)."""
    port, pallas, oracle = _run(*_inputs(2, 100, 4, 4, 32, 7, scale=3.0),
                                torch.float32, window=16, logit_softcap=20.0)
    _assert_close(port, pallas)
    _assert_close(port, oracle)


def test_softcap_matches_reference():
    """Measured: at most 1.1e-6·max|out| from either."""
    port, pallas, oracle = _run(*_inputs(1, 64, 2, 2, 32, 3, scale=3.0),
                                torch.float32, logit_softcap=20.0)
    _assert_close(port, pallas)
    _assert_close(port, oracle)


def test_bf16_matches_reference():
    """bf16 in and out, f32 inside (measured: 3 of 8,192 values differ
    from the oracle's and 2 from the Pallas kernel's, each by one bf16
    ulp, 1.8e-4·max|out|)."""
    port, pallas, oracle = _run(*_inputs(1, 128, 2, 2, 32, 11),
                                torch.bfloat16, window=64)
    _assert_close(port, pallas, bf16=True)
    _assert_close(port, oracle, bf16=True)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is ``flash_attention_ref`` exactly and
    launches nothing."""
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 40, 4, 2, 16, 5))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, window=8, logit_softcap=5.0)
    assert torch.equal(out, tfa.flash_attention_ref(q, k, v, window=8,
                                                    logit_softcap=5.0))
    assert tfa.flash_attention.launches == before


def test_wrapper_checks_shapes_before_anything():
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 16, 3, 2, 16, 0))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q[:, :8], k[..., :2, :], v[..., :2, :])
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q.double()[..., :2, :], k.double(), v.double())
