"""Port parity for the legacy K-way MAC: ``gossip_mix_ref`` (the plain
version of the ``gossip_mix`` CUDA kernel) and its per-leaf fan-out
``mix_dense_rows`` against the reference's ``gossip_mix_pallas`` and
``mix_dense_pallas`` (interpret mode on the CPU, as
``tests/test_kernels.py::TestGossipMix`` runs them), and the byte model of
every mix backend.  The kernel itself is held to its plain version on the
card in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gossip_mix as jgm
from repro_torch.kernels import gossip_mix as tgm

torch.set_num_threads(2)

# tests/test_kernels.py::TestGossipMix's shapes
SHAPES = [(2, 8, 8), (4, 100, 130), (7, 256, 512), (3, 1, 700), (5, 513, 129)]


def _case(k, m, n, r=None):
    rng = np.random.default_rng(1000 * k + m + n)
    blocks = (rng.normal(size=(k, m, n)) * 2).astype(np.float32)
    w = rng.random((k,) if r is None else (r, k)).astype(np.float32)
    return blocks, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("k,m,n", SHAPES)
def test_f32_plain_matches_pallas(k, m, n):
    """The Pallas kernel in interpret mode fuses each multiply-add (XLA on
    the CPU), the plain version rounds the product and the sum apart, so
    they part in the last bits.  Measured: at most 4.8e-7 absolute on
    sums of magnitude up to ~8 (two f32 ulps there).  Pinned: 1e-6
    absolute plus 2^-21 relative (four ulps)."""
    blocks, w = _case(k, m, n)
    ref = jgm.gossip_mix_pallas(jnp.asarray(blocks), jnp.asarray(w))
    out = tgm.gossip_mix(torch.as_tensor(blocks), torch.as_tensor(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2.0 ** -21,
                               atol=1e-6)


@pytest.mark.parametrize("k,m,n", SHAPES)
def test_bf16_plain_within_one_ulp_of_pallas(k, m, n):
    """bf16 blocks, f32 sums cast once: the two f32 sums above round to
    the same bf16 or its neighbour, except near zero, where the f32 sums'
    own few-ulp difference is larger than a bf16 ulp of the result
    (measured: one value of 66,177 at (5, 513, 129), 4.9e-8 against
    4.5e-8).  Pinned: one bf16 ulp beyond the f32 bound of 1e-6."""
    blocks, w = _case(k, m, n)
    ref = np.asarray(jgm.gossip_mix_pallas(
        jnp.asarray(blocks).astype(jnp.bfloat16), jnp.asarray(w)), np.float32)
    out = tgm.gossip_mix(torch.as_tensor(blocks).to(torch.bfloat16),
                         torch.as_tensor(w))
    assert out.dtype == torch.bfloat16
    assert np.all(np.abs(out.float().numpy() - ref)
                  <= _bf16_ulp(ref) + 1e-6)


@pytest.mark.parametrize("k,m,n,r", [(5, 7, 130, 3), (3, 1, 700, 2),
                                     (4, 2, 1, 3)])
def test_rows_match_vmapped_pallas(k, m, n, r):
    """Weights (R, K): one call for all R rows, as ``jax.vmap`` of the
    kernel over the rows.  Measured 4.8e-7 at most; pinned as above."""
    blocks, w = _case(k, m, n, r)
    ref = jax.vmap(lambda wr: jgm.gossip_mix_pallas(jnp.asarray(blocks), wr)
                   )(jnp.asarray(w))
    out = tgm.gossip_mix(torch.as_tensor(blocks), torch.as_tensor(w))
    assert tuple(out.shape) == (r, m, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2.0 ** -21,
                               atol=1e-6)


def test_plain_version_sums_in_ascending_order():
    """Each product and each sum rounded apart, from 0, in ascending k —
    the arithmetic the CUDA kernel repeats with ``__fmul_rn`` /
    ``__fadd_rn``; checked against numpy f32 op by op."""
    blocks, w = _case(6, 3, 37, 4)
    acc = np.zeros((4, 3, 37), np.float32)
    for k in range(6):
        acc = (acc + (w[:, k, None, None] * blocks[k]).astype(np.float32)
               ).astype(np.float32)
    out = tgm.gossip_mix_ref(torch.as_tensor(blocks), torch.as_tensor(w))
    assert np.array_equal(out.numpy(), acc)


def _ragged_tree(n, seed):
    """Four leaves as the reference's ``_ragged_params`` shapes them: a
    matrix, a 96-wide matrix, a 129-wide bias (N = 129) and one scalar a
    node (N = 1)."""
    rng = np.random.default_rng(seed)
    return {"w_big": rng.normal(size=(n, 20, 128)).astype(np.float32),
            "w_mid": rng.normal(size=(n, 9, 96)).astype(np.float32),
            "bias": rng.normal(size=(n, 129)).astype(np.float32),
            "scale": rng.normal(size=(n,)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mix_dense_rows_matches_mix_dense_pallas(dtype):
    """The fan-out over a 4-leaf ragged tree at n = 8: each leaf mixed to
    its own shape and dtype.  Measured f32: 2.4e-7 at most; bf16: within
    one ulp.  Pinned: f32 1e-6 + 2^-21 relative, bf16 one ulp beyond the
    f32 bound."""
    n = 8
    tree = _ragged_tree(n, 3)
    rng = np.random.default_rng(4)
    c = rng.random((n, n)).astype(np.float32)
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jgm.mix_dense_pallas(
        {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()},
        jnp.asarray(c))
    out = tgm.mix_dense_rows(
        {k: torch.as_tensor(v).to(tdt) for k, v in tree.items()},
        torch.as_tensor(c))
    for k in tree:
        assert out[k].dtype == tdt and out[k].shape == tree[k].shape
        got = out[k].float().numpy()
        want = np.asarray(ref[k], np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2.0 ** -21, atol=1e-6)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-6), k


def test_plain_version_is_the_cpu_path_and_shapes_are_checked():
    """On the CPU the wrapper returns the plain version and counts no
    launch; malformed operands raise before anything runs."""
    blocks, w = _case(3, 2, 5)
    before = tgm.gossip_mix.launches
    out = tgm.gossip_mix(torch.as_tensor(blocks), torch.as_tensor(w))
    assert torch.equal(out, tgm.gossip_mix_ref(torch.as_tensor(blocks),
                                               torch.as_tensor(w)))
    assert tgm.gossip_mix.launches == before
    with pytest.raises(ValueError, match="weights"):
        tgm.gossip_mix(torch.as_tensor(blocks), torch.ones(4))
    with pytest.raises(ValueError, match="blocks"):
        tgm.gossip_mix(torch.ones(3, 4), torch.ones(3))


IMPLS = [("einsum", {}), ("pallas_rows", {}), ("pallas_plane", {}),
         ("pallas_plane_e2e", {}), ("edges", {"max_neighbors": 15}),
         ("edges_robust", {"max_neighbors": 15}), ("sparse", {"n_offsets": 9})]


@pytest.mark.parametrize("impl,kw", IMPLS)
@pytest.mark.parametrize("n,p,itemsize,n_leaves,bt", [
    (8, 48_000, 4, 4, 1024), (33, 118_282, 4, 6, 2048),
    (33, 14_982_479, 2, 35, 1024), (1024, 118_282, 4, 6, 1024)])
def test_modeled_bytes_equal_reference(impl, kw, n, p, itemsize, n_leaves,
                                       bt):
    assert tgm.mix_modeled_hbm_bytes(
        impl, n, p, itemsize=itemsize, n_leaves=n_leaves, bt=bt, **kw) == \
        jgm.mix_modeled_hbm_bytes(impl, n, p, itemsize=itemsize,
                                  n_leaves=n_leaves, bt=bt, **kw)


def test_modeled_bytes_raise_as_reference():
    for impl in ("edges", "edges_robust", "sparse"):
        with pytest.raises(ValueError):
            tgm.mix_modeled_hbm_bytes(impl, 8, 100)
    with pytest.raises(KeyError):
        tgm.mix_modeled_hbm_bytes("segment", 8, 100)
