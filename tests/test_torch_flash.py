"""Port parity for flash attention: the port's plain version
``flash_attention_ref`` (what ``flash_attention`` runs on CPU tensors)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs."""
import math

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_96_matches_reference(dtype):
    """hd 96 (phi3-mini-3.8b's 3072 / 32), scale 1/√96, at (1, 64, 4 over
    2).  Measured: f32 at most 2.5e-7·max|out| from the Pallas kernel and
    1.2e-7·max|out| from the oracle; bf16 10 and 3 of 24,576 values one
    bf16 ulp apart (0.971 and 0.805 of the card's bf16 gate)."""
    port, pallas, oracle = _run(*_inputs(1, 64, 4, 2, 96, 96), dtype)
    bf16 = dtype == torch.bfloat16
    _assert_close(port, pallas, bf16=bf16)
    _assert_close(port, oracle, bf16=bf16)


def _emulate_tensor_cores(q, k, v, window, logit_softcap, pieces=2,
                          keys=64):
    """The bf16 card kernel's arithmetic (``flash_tc_kernel``) in plain
    PyTorch, for these tests only: f32 logits of the bf16 q·k (the
    tensor cores multiply bf16 exactly and sum in f32) times 1/√hd, the
    cap, the −1e30 mask, the online softmax over tiles of ``keys`` keys
    with p = exp2((x − m)·log2 e) and l summed from the f32 p, and
    P·V with p split into ``pieces`` bf16 pieces (each the bf16 rounding
    of what the earlier ones left), each product summed in f32; the
    output rounded once to bf16.  Causal."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    log2e = 1.4426950408889634
    qf, kf, vf = (x.float() for x in (q, k, v))
    kf, vf = (x.repeat_interleave(g, dim=2) for x in (kf, vf))
    qi = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    for t0 in range(0, s, keys):
        kt, vt = kf[:, t0:t0 + keys], vf[:, t0:t0 + keys]
        x = torch.einsum("bshd,bthd->bhst", qf, kt) * (1.0 / math.sqrt(hd))
        if logit_softcap > 0:
            x = torch.tanh(x / logit_softcap) * logit_softcap
        ki = torch.arange(t0, t0 + kt.shape[1])[None, :]
        ok = (ki <= qi) & (ki > qi - window) if window > 0 else ki <= qi
        x = x.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((x - m_new) * log2e)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(pieces):
            piece = rest.to(torch.bfloat16).float()
            rest = rest - piece
            acc = acc + torch.einsum("bhst,bthd->bhsd", piece, vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def _bf16_gate_use(port, other):
    """max |port − other| / (one bf16 ulp of other + 2e-5·max|other|):
    the card's bf16 gate holds where this is at most 1."""
    gate = 2e-5 * np.abs(other).max() + 2.0 ** (np.floor(np.log2(
        np.maximum(np.abs(other), 2.0 ** -126))) - 7)
    return float((np.abs(port - other) / gate).max())


_TC_CASES = [(1, 512, 4, 2, 64), (1, 300, 4, 4, 128), (1, 300, 4, 2, 96)]


def _tc_inputs(b, s, h, kv, hd):
    """bf16 inputs and the JAX Pallas kernel's (interpret mode) and jnp
    oracle's outputs as f32 numpy, cap 50 and window 100."""
    q, k, v = _inputs(b, s, h, kv, hd, s + hd)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    kw = dict(window=100, logit_softcap=50.0)
    pallas = flash_attention_pallas(jq, jk, jv, bq=128, bkv=128, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    return ((tq, tk, tv), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("b,s,h,kv,hd", _TC_CASES)
def test_tensor_core_arithmetic_matches_reference(b, s, h, kv, hd):
    """The bf16 card kernel's numerical contract, pinned before the card
    sees it: bf16 tensor-core logits and p split into two bf16 pieces
    stay within the card's bf16 gate of the JAX Pallas kernel (interpret
    mode) and of its oracle.  Measured: at most 0.987 of the gate at
    (1, 512, 4, 2, 64), 0.966 at (1, 300, 4, 4, 128) and 0.968 at (1,
    300, 4, 2, 96), against either (the Pallas kernel and the oracle are
    0.948, 0.966 and 0.968 of it apart): two f32 computations rounded to
    bf16 each."""
    (tq, tk, tv), pallas, oracle = _tc_inputs(b, s, h, kv, hd)
    port = _emulate_tensor_cores(tq, tk, tv, 100, 50.0).float().numpy()
    assert _bf16_gate_use(port, pallas) <= 1.0
    assert _bf16_gate_use(port, oracle) <= 1.0


@pytest.mark.parametrize("b,s,h,kv,hd", _TC_CASES)
def test_one_bf16_p_exceeds_the_gate(b, s, h, kv, hd):
    """Why p is split: with one bf16 p (an error of up to 2^-9 of each
    weight) the same inputs leave the bf16 gate by far (measured: 17.1×,
    14.7× and 29.5× the gate, against either)."""
    (tq, tk, tv), pallas, oracle = _tc_inputs(b, s, h, kv, hd)
    port = _emulate_tensor_cores(tq, tk, tv, 100, 50.0,
                                 pieces=1).float().numpy()
    assert _bf16_gate_use(port, pallas) > 10.0
    assert _bf16_gate_use(port, oracle) > 10.0


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
