"""Port parity for MLA (multi-head latent attention, deepseek-v2): the
plain latent attention against the JAX package's jnp reference and its
Pallas kernel (interpret mode), ``mla_apply`` in every implementation and
both query paths, ``mla_decode``, and the MLA model's ``forward`` /
``decode_step`` on the same parameters (``params_from_jax``) and the same
numpy inputs: deepseek-v2-236b's ``smoke()`` cut to its dense first layer
(``q_lora_rank`` 48) and ``tests/test_serving.py``'s ``MLA`` config with
no experts (2 layers, ``q_lora_rank`` 0)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.registry import get_config as jfull
from repro.configs.registry import get_smoke_config as jget
from repro.kernels.mla_attention import mla_attention_pallas
from repro.kernels.ref import mla_attention_ref as jref
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.registry import get_config as tfull
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.interop import params_from_jax
from repro_torch.kernels import mla_attention as tk
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
# tests/test_serving.py's MLA config without its experts: the reference
# runs it as a dense stack of MLA layers
MLA_FIELDS = dict(name="mla", family="moe", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=64,
                  use_mla=True, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, n_experts=0,
                  dtype="float32", param_dtype="float32")


def _configs(name, dtype="float32"):
    """(JAX config, port config): ``"cut"`` is deepseek-v2's smoke config
    cut to its dense first layer, ``"mla"`` the dense MLA config."""
    if name == "cut":
        jc, tc = jget(ARCH), tget(ARCH)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        jc, tc = (dataclasses.replace(c, n_layers=c.first_k_dense)
                  for c in (jc, tc))
    else:
        jc, tc = JConfig(**MLA_FIELDS), TConfig(**MLA_FIELDS)
    return (dataclasses.replace(jc, dtype=dtype, param_dtype=dtype),
            dataclasses.replace(tc, dtype=dtype, param_dtype=dtype))


CONFIGS = ("cut", "mla")
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


# ----------------------------------------------------------------------
# the plain latent attention
# ----------------------------------------------------------------------
def _attn_inputs(b, s, h, r, dr, t=None, seed=0):
    """q_lat, q_rope, c_kv, k_rope ~ N(0, 0.3²) as numpy f32 (the scale of
    ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    t = t or s
    return tuple((rng.normal(size=shape) * 0.3).astype(np.float32)
                 for shape in ((b, s, h, r), (b, s, h, dr), (b, t, r),
                               (b, t, dr)))


@pytest.mark.parametrize("b,s,h,r,dr,blk", [
    (1, 128, 4, 32, 16, 64), (2, 100, 2, 64, 16, 32), (1, 64, 8, 16, 8, 64),
])
def test_plain_version_matches_reference_and_pallas(b, s, h, r, dr, blk):
    """``mla_attention_ref`` against the jnp ``mla_attention_ref`` within
    1e-6 (measured at most 1.6e-7, |out| up to 0.85) and against
    ``mla_attention_pallas`` in interpret mode (T = S) within 1e-6
    (measured at most 1.8e-7); the wrapper takes the plain version for
    CPU tensors and counts no launch."""
    x = _attn_inputs(b, s, h, r, dr)
    got = tk.mla_attention_ref(*(torch.as_tensor(a) for a in x)).numpy()
    want = np.asarray(jref(*(jnp.asarray(a) for a in x)))
    pallas = np.asarray(mla_attention_pallas(*(jnp.asarray(a) for a in x),
                                             bq=blk, bkv=blk))
    assert got.shape == (b, s, h, r)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    before = tk.mla_attention.launches
    wrapped = tk.mla_attention(*(torch.as_tensor(a) for a in x))
    assert torch.equal(wrapped, torch.as_tensor(got))
    assert tk.mla_attention.launches == before


def test_fewer_latent_rows_than_queries():
    """T = 40 < S = 64: the plain version masks ``t <= s`` over the T real
    latent rows, as the jnp reference does (within 1e-6, measured
    7.5e-8).  The Pallas kernel masks ``t < S`` over a latent it pads
    with zero rows to a block multiple (``bkv = 32``): it agrees on the
    rows s < T (measured 8.9e-8) and lets the padding into the softmax of
    the rows s >= T (measured up to 0.055 off there).  The port's CUDA
    kernel follows the plain version; its one caller, prefill, has T = S,
    where the two kernels agree."""
    x = _attn_inputs(1, 64, 2, 16, 8, t=40)
    got = tk.mla_attention_ref(*(torch.as_tensor(a) for a in x)).numpy()
    want = np.asarray(jref(*(jnp.asarray(a) for a in x)))
    pallas = np.asarray(mla_attention_pallas(*(jnp.asarray(a) for a in x),
                                             bq=32, bkv=32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, :40], pallas[:, :40], rtol=0, atol=1e-6)
    assert np.abs(got[:, 40:] - pallas[:, 40:]).max() > 1e-2


def test_bf16_latent_and_refusals():
    """bf16 latents with f32 queries (the model path): f32 out within
    1e-6 of the jnp reference on the same values (measured 1.2e-7); all
    bf16: bf16 out within one bf16 ulp of the reference's beyond 1e-6
    (measured: one output of 4,608 more than one ulp off, by 3.7e-9
    near zero).  The types and shapes the kernel has no case for are
    refused before any work."""
    x = [torch.as_tensor(a) for a in _attn_inputs(2, 48, 3, 32, 8)]
    ql, qr, ck, kr = x
    ckb, krb = ck.to(torch.bfloat16), kr.to(torch.bfloat16)
    want = np.asarray(jref(jnp.asarray(ql.numpy()), jnp.asarray(qr.numpy()),
                           jnp.asarray(ckb.float().numpy()),
                           jnp.asarray(krb.float().numpy())))
    got = tk.mla_attention(ql, qr, ckb, krb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    got16 = tk.mla_attention(ql.to(torch.bfloat16), qr.to(torch.bfloat16),
                             ckb, krb)
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(jref(*(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16) for a in (ql, qr, ckb, krb))).astype(jnp.float32))
    assert (np.abs(got16.float().numpy() - want16)
            <= _bf16_ulp(want16) + 1e-6).all()
    with pytest.raises(TypeError, match="dtype"):
        tk.mla_attention(ql.to(torch.bfloat16), qr.to(torch.bfloat16), ck,
                         kr)
    with pytest.raises(TypeError, match="dtype"):
        tk.mla_attention(ql, qr, ck, krb)
    with pytest.raises(ValueError, match="match"):
        tk.mla_attention(ql, qr[..., :4], ck, kr)
    with pytest.raises(ValueError, match="expected"):
        tk.mla_attention(ql[0], qr, ck, kr)


# ----------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated
# ----------------------------------------------------------------------
def _split(x, pieces):
    """x as ``pieces`` bf16 pieces (f32 tensors), each the bf16 rounding
    of what the earlier ones left (``sm90::split_bf16``)."""
    out = []
    for _ in range(pieces):
        piece = x.to(torch.bfloat16).float()
        x = x - piece
        out.append(piece)
    return out


def _emulate_tensor_cores(q_lat, q_rope, c_kv, k_rope, q_pieces=2,
                          p_pieces=2, keys=32):
    """The card's ``mla_tc_kernel`` arithmetic in plain PyTorch, for these
    tests only: f32 logits of [q_lat ‖ q_rope], split into ``q_pieces``
    bf16 pieces, against the bf16 [c_kv ‖ k_rope] (the tensor cores
    multiply bf16 exactly and sum in f32), the −1e30 causal mask, the
    online softmax over tiles of ``keys`` latent rows with
    p = exp2((x − m)·log2 e) and l summed from the f32 p, and p·c_kv with
    p split into ``p_pieces`` bf16 pieces, each product summed in f32;
    the output rounded once to q's type.  (The card visits only the tiles
    a block's rows can see; a later tile adds p = 0 here.)"""
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    log2e = 1.4426950408889634
    qs = _split(torch.cat([q_lat, q_rope], -1).float(), q_pieces)
    kv = torch.cat([c_kv, k_rope], -1).float()
    ck = c_kv.float()
    qi = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, r))
    for t0 in range(0, t, keys):
        x = sum(torch.einsum("bshw,btw->bhst", q, kv[:, t0:t0 + keys])
                for q in qs)
        ki = torch.arange(t0, min(t, t0 + keys))[None, :]
        x = x.masked_fill(~(ki <= qi), -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((x - m_new) * log2e)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for piece in _split(p, p_pieces):
            acc = acc + torch.einsum("bhst,btr->bhsr", piece,
                                     ck[:, t0:t0 + keys])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q_lat.dtype)


_TC_CASES = [(1, 256, 2), (2, 96, 3)]
_TC_EMULATED = {}


def _tc_case(b, s, h):
    """``chip_smoke.py``'s MLA inputs at r 512, dr 64: q ~ N(0, 1)·2/√576
    in f32, the latent ~ N(0, 1) in bf16 (numpy, seeded); the JAX Pallas
    kernel's (interpret mode) and jnp reference's outputs on the same
    values, f32 numpy."""
    if (b, s, h) not in _TC_EMULATED:
        rng = np.random.default_rng(s + h)
        qs = 2.0 / np.sqrt(576)
        ql, qr = (torch.as_tensor((rng.normal(size=(b, s, h, w)) * qs).astype(
            np.float32)) for w in (512, 64))
        ck, kr = (torch.as_tensor(rng.normal(size=(b, s, w)).astype(
            np.float32)).to(torch.bfloat16) for w in (512, 64))
        jx = [jnp.asarray(a.float().numpy()) for a in (ql, qr, ck, kr)]
        jx[2:] = [a.astype(jnp.bfloat16) for a in jx[2:]]
        pallas = np.asarray(mla_attention_pallas(*jx, bq=128, bkv=128))
        oracle = np.asarray(jref(*jx))
        _TC_EMULATED[(b, s, h)] = ((ql, qr, ck, kr), pallas, oracle)
    return _TC_EMULATED[(b, s, h)]


def _f32_gate_use(port, other):
    """max |port − other| / (2e-5·max|other|), the card's f32 gate
    (``chip_smoke.py`` MLA_F32_TOL): it holds where this is at most 1."""
    return float(np.abs(port - other).max() / (2e-5 * np.abs(other).max()))


@pytest.mark.parametrize("b,s,h", _TC_CASES)
def test_tensor_core_arithmetic_matches_reference(b, s, h):
    """The card's tensor-core numerical contract, pinned before the card
    sees it: q and p each in two bf16 pieces, 32-row latent tiles, exp2,
    l from the f32 p, stay within the card's f32 gate of the JAX Pallas
    kernel (interpret mode) and of its jnp reference, at deepseek-v2's
    ranks.  Measured: 0.280 of the gate at (1, 256, 2) and 0.227 at
    (2, 96, 3), against either (the Pallas kernel and the reference are
    0.045 and 0.025 of it apart; three pieces of q would give 0.10)."""
    x, pallas, oracle = _tc_case(b, s, h)
    port = _emulate_tensor_cores(*x).numpy()
    assert port.shape == (b, s, h, 512)
    assert _f32_gate_use(port, pallas) <= 1.0
    assert _f32_gate_use(port, oracle) <= 1.0


@pytest.mark.parametrize("q_pieces,p_pieces", [(1, 2), (2, 1)])
@pytest.mark.parametrize("b,s,h", _TC_CASES)
def test_one_bf16_piece_of_q_or_p_exceeds_the_gate(b, s, h, q_pieces,
                                                   p_pieces):
    """Why both are split: one bf16 piece of q (logits off by up to 2^-9
    of each |q_i·k_i|) or of p (each weight off by up to 2^-9) leaves the
    f32 gate by far.  Measured against either reference: one piece of q
    152× and 185× the gate, one of p 43.3× and 51.0×, at (1, 256, 2) and
    (2, 96, 3)."""
    x, pallas, oracle = _tc_case(b, s, h)
    port = _emulate_tensor_cores(*x, q_pieces=q_pieces,
                                 p_pieces=p_pieces).numpy()
    assert _f32_gate_use(port, pallas) > 10.0
    assert _f32_gate_use(port, oracle) > 10.0


@pytest.mark.parametrize("kv_dtype,r,dr,kernel", [
    (torch.bfloat16, 512, 64, "mla_tc_kernel"),
    (torch.bfloat16, 32, 8, "mla_tc_kernel"),
    (torch.float32, 512, 64, "mla_kernel"),
    (torch.float32, 32, 16, "mla_kernel"),
])
def test_kernel_rule_and_cpu_calls_launch_nothing(kv_dtype, r, dr, kernel):
    """The wrapper's rule (``kernel_for``): a bf16 latent goes to
    ``mla_tc_kernel`` on the card, an f32 one to ``mla_kernel``.  CPU
    tensors take the plain version whatever the rule says and count no
    launch of either kernel."""
    x = [torch.as_tensor(a) for a in _attn_inputs(1, 20, 2, r, dr)]
    x[2:] = [a.to(kv_dtype) for a in x[2:]]
    assert tk.kernel_for(x[2]) == kernel
    before = dict(tk.mla_attention.kernel_launches)
    got = tk.mla_attention(*x)
    assert torch.equal(got, tk.mla_attention_ref(*x))
    assert tk.mla_attention.kernel_launches == before


# ----------------------------------------------------------------------
# the MLA layer
# ----------------------------------------------------------------------
def _layer_params(q_lora):
    """One MLA layer of the cut config's dims (``q_lora_rank`` 48 or 0):
    the JAX init and the port's copy with a node axis of 1."""
    jc, tc = (dataclasses.replace(c, q_lora_rank=q_lora)
              for c in _configs("cut"))
    jp = jax.jit(lambda k: jl.mla_init(k, jc, jnp.float32))(
        jax.random.key(q_lora))
    tp = tt.add_node_axis(params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))
    return jc, tc, jp, tp


@pytest.mark.parametrize("q_lora", [48, 0])
@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
def test_mla_apply_matches_reference(impl, q_lora):
    """``mla_apply`` (the kernel branch takes the plain version on the
    CPU, the JAX side its Pallas kernel in interpret mode) within 2e-5 of
    the reference's on the same x ~ N(0, 1) (measured at most 7.6e-6,
    |out| up to 16.8: 5e-7 of it), for both query paths."""
    jc, tc, jp, tp = _layer_params(q_lora)
    x = np.random.default_rng(2).normal(size=(2, 32, jc.d_model)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jl.mla_apply(
        p, jc, x, jnp.arange(32), impl=impl))(jp, jnp.asarray(x)))
    got = tl.mla_apply(tp, tc, torch.as_tensor(x)[None], torch.arange(32),
                       impl=impl)[0]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_mla_chunked_keeps_the_block_assertion():
    _, tc, _, _ = _layer_params(48)
    q = torch.zeros((1, 100, 4, 32))
    with pytest.raises(AssertionError):
        tl.mla_chunked(tc, q, q[..., :16], q[:, :, 0], q[:, :, 0, :16],
                       bq=64, bkv=64)


@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_decode_matches_reference(q_lora):
    """Ten ``mla_decode`` steps from a zero cache, two sequences at
    different positions, x ~ N(0, 1): outputs within 2e-5 (measured at
    most 4.8e-6, |out| up to 15.6) and the latent and rope-key caches
    within 1e-5 (measured 2.4e-7 and 1.3e-6) of the reference's one-hot
    blend; a position past T writes nothing."""
    jc, tc, jp, tp = _layer_params(q_lora)
    t = 12
    jck = jnp.zeros((2, t, jc.kv_lora_rank))
    jkr = jnp.zeros((2, t, jc.qk_rope_head_dim))
    tck, tkr = torch.zeros((1, 2, t, jc.kv_lora_rank)), torch.zeros(
        (1, 2, t, jc.qk_rope_head_dim))
    rng = np.random.default_rng(3)
    step = jax.jit(lambda p, x, c, k, pos: jl.mla_decode(p, jc, x, c, k, pos))
    for i in range(10):
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        pos = np.array([i, i + 3 if i < 8 else t + 1], np.int32)
        want, jck, jkr = step(jp, jnp.asarray(x), jck, jkr, jnp.asarray(pos))
        got, tck, tkr = tl.mla_decode(tp, tc, torch.as_tensor(x)[None], tck,
                                      tkr, torch.as_tensor(pos)[None])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)
    np.testing.assert_allclose(tck[0].numpy(), np.asarray(jck), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tkr[0].numpy(), np.asarray(jkr), rtol=0,
                               atol=1e-5)
    # the second sequence wrote slots 3 to 10; its positions 13 wrote
    # nothing
    assert float(tck[0, 1, :3].abs().max()) == 0.0
    assert float(tck[0, 1, 11:].abs().max()) == 0.0


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_reference_f32(name, impl):
    """f32 logits within 1e-5 of the reference's (measured at most
    3.2e-6 for the cut config, 2.3e-6 for the MLA one, |logits| up to
    4.1)."""
    jc, tc = _configs(name)
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
def test_forward_matches_reference_bf16(impl):
    """The cut config in bf16 (the type the chip runs): logits, bf16
    values cast to f32 on both sides, within two bf16 ulps of the largest
    logit (measured 0.0176 einsum, 0.0234 kernel branch at |logits| up to
    4.06: between one and two ulps of 0.0156 below 4)."""
    jc, tc = _configs("cut", "bfloat16")
    jp, tp = _params(jc, tc)
    toks = _tokens(jc.vocab_size, (2, 64))
    ref = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, jc, {"tokens": t}, jt.ForwardOptions(attn_impl=impl,
                                                remat=False))[0])(
        jp, jnp.asarray(toks)))
    out = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                     tt.ForwardOptions(attn_impl=impl))[0].numpy()
    assert np.abs(out - ref).max() <= 2 * _bf16_ulp(np.abs(ref).max())


def _decode_all_port(tc, tp, toks, max_seq):
    cache = tt.init_cache(tc, toks.shape[0], max_seq, device="cpu")
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = tt.decode_step(tp, tc,
                                       torch.as_tensor(toks[:, i:i + 1]),
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


@pytest.mark.parametrize("name", CONFIGS)
def test_init_cache_and_decode_step_match_reference(name):
    """The latent cache has the reference's leaves, shapes and types, and
    12 cached decode steps give logits within 1e-5 of the reference's
    (measured at most 1.9e-6), the ``ckv``/``kr`` caches within 1e-5
    (measured at most 1.2e-6) and the positions exactly."""
    jc, tc = _configs(name)
    jp, tp = _params(jc, tc)
    jcache, tcache = jt.init_cache(jc, 2, 16), tt.init_cache(tc, 2, 16,
                                                             device="cpu")
    assert sorted(tcache) == sorted(jcache) == ["ckv", "kr", "position"]
    for k in tcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert str(tcache[k].dtype)[6:] == str(jcache[k].dtype)
    toks = _tokens(jc.vocab_size, (2, 12), seed=2)
    out, cache = _decode_all_port(tc, tp, toks, 16)
    ref, jcache = _decode_all_jax(jc, jp, toks, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_matches_forward(name):
    """The serving invariant (``tests/test_serving.py``): token-by-token
    cached decode reproduces the full-sequence forward's logits, within
    the reference's own 3e-3 and to 1e-5 (measured at most 1.5e-6)."""
    jc, tc = _configs(name)
    _, tp = _params(jc, tc)
    toks = _tokens(jc.vocab_size, (2, 12), seed=3)
    full = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)})[0].numpy()
    inc, _ = _decode_all_port(tc, tp, toks, 16)
    np.testing.assert_allclose(inc, full, rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(inc, full, rtol=0, atol=1e-5)


def test_init_params_tree_at_full_width(monkeypatch):
    """deepseek-v2-236b at full width cut to its dense first layer (what
    ``chip_smoke.py`` serves): the port's init builds the reference's
    tree, the 17 leaves that ``jax.eval_shape`` gives with their shapes
    and types, 1,386,562,560 parameters, all bf16.  The draws are
    replaced by empty tensors on the meta device, so the test allocates
    nothing."""
    jc = dataclasses.replace(jfull(ARCH), n_layers=1)
    tc = dataclasses.replace(tfull(ARCH), n_layers=1)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                            jax.random.key(0))
    empty = lambda gen, shape, dtype, scale=None, stacked=0: torch.empty(
        tuple(shape), dtype=dtype, device="meta")
    monkeypatch.setattr(tl, "dense_init_on_device", empty)
    monkeypatch.setattr(tt, "dense_init_on_device", empty)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert got == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                               shapes)
    leaves = jax.tree.leaves(shapes)
    assert len(leaves) == 17 and {str(s.dtype) for s in leaves} == {
        "bfloat16"}
    assert sum(int(np.prod(s.shape)) for s in leaves) == 1_386_562_560
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == 1_386_562_560


def test_check_supported_admits_only_the_dense_cut():
    """The port's stack no longer refuses any config, so what the old
    refusal guarded is held to the reference instead: MLA with Mamba
    heads beside it (the MLA config with ``hybrid_ssm``; the reference
    mixes ``mla_apply``'s output with the Mamba block's, and threads
    ``ssm_state``/``conv_state`` beside the latent cache).  Its forward
    logits, 8 decode steps' logits and the final cache within 1e-5 of
    the reference's (measured at most 3.0e-6)."""
    fields = dict(MLA_FIELDS, name="mla-hybrid", hybrid_ssm=True,
                  ssm_state_dim=8, ssm_expand=2, ssm_conv_dim=4)
    jc, tc = JConfig(**fields), TConfig(**fields)
    jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(0))
    like = tt.init_params(torch.Generator().manual_seed(0), tc)
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), "cpu", like=like)
    assert "mamba" in tp["dense_layers"] and "w_dkv" in tp["dense_layers"][
        "attn"]
    toks = _tokens(jc.vocab_size, (2, 8), seed=9)
    for impl in ("einsum", "chunked"):
        ref = np.asarray(jax.jit(lambda p, t: jt.forward(
            p, jc, {"tokens": t}, jt.ForwardOptions(attn_impl=impl,
                                                    remat=False))[0])(
            jp, jnp.asarray(toks)))
        out = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                         tt.ForwardOptions(attn_impl=impl))[0]
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    jcache = jt.init_cache(jc, 2, 8)
    cache = tt.init_cache(tc, 2, 8, device="cpu")
    assert sorted(cache) == sorted(jcache) == [
        "ckv", "conv_state", "kr", "position", "ssm_state"]
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    for i in range(8):
        jlog, jcache = step(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        log, cache = tt.decode_step(tp, tc,
                                    torch.as_tensor(toks[:, i:i + 1]), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-5)
    for k in cache:
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   rtol=0, atol=1e-5)
