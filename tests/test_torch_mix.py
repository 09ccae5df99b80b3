"""Port parity for Eq. (2): the plain versions of the two CUDA kernels
against the reference's Pallas kernels (interpret mode on the CPU), and
the tree-level mixes against the dense einsum.  The kernels themselves are
held against their plain versions on the card in ``test_torch_cuda.py``
and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_mix import gossip_edges_pallas, gossip_plane_pallas
from repro_torch.core import topology as ttopo
from repro_torch.core.mixing import edge_weights, mix_dense, mix_edges
from repro_torch.kernels import gossip_mix as tk

torch.set_num_threads(2)


def _inputs(n, p, seed, sparse=True):
    rng = np.random.default_rng(seed)
    plane = rng.normal(size=(n, p)).astype(np.float32)
    topo = ttopo.barabasi_albert(n, 2, seed) if n > 2 else ttopo.ring(n)
    idx, msk = topo.neighbor_tables()
    c = rng.random((n, n)).astype(np.float32)
    if sparse:
        c = c * (topo.adjacency + np.eye(n)).astype(np.float32)
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    return plane, c, idx, msk


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _port_edges(plane_t, c, idx, msk, f32=True):
    w = edge_weights(torch.as_tensor(c), torch.as_tensor(idx),
                     torch.as_tensor(msk))
    return tk.gossip_edges(plane_t, w, torch.as_tensor(idx), f32)


def _jax_edges(plane_j, c, idx, msk, f32=True):
    w = jnp.asarray(c)[jnp.arange(c.shape[0])[:, None], idx] * msk
    return gossip_edges_pallas(plane_j, w, jnp.asarray(idx),
                               mix_in_float32=f32)


SHAPES = [(4, 7), (8, 300), (13, 2500), (16, 4097)]


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("kernel", ["plane", "edges"])
def test_f32_plain_matches_pallas(n, p, kernel):
    plane, c, idx, msk = _inputs(n, p, n + p)
    pt = torch.as_tensor(plane)
    if kernel == "plane":
        ref = gossip_plane_pallas(jnp.asarray(plane), jnp.asarray(c))
        out = tk.gossip_plane(pt, torch.as_tensor(c))
    else:
        ref = _jax_edges(jnp.asarray(plane), c, idx, msk)
        out = _port_edges(pt, c, idx, msk)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("kernel", ["plane", "edges"])
def test_bf16_plane_f32_accumulation_within_one_ulp(n, p, kernel):
    """f32 sums in another order round to the same bf16 or its neighbour."""
    plane, c, idx, msk = _inputs(n, p, 7 * n + p)
    pj = jnp.asarray(plane).astype(jnp.bfloat16)
    pt = torch.as_tensor(plane).to(torch.bfloat16)
    if kernel == "plane":
        ref = gossip_plane_pallas(pj, jnp.asarray(c))
        out = tk.gossip_plane(pt, torch.as_tensor(c))
    else:
        ref = _jax_edges(pj, c, idx, msk)
        out = _port_edges(pt, c, idx, msk)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    assert np.all(np.abs(got - ref) <= _bf16_ulp(ref))


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("kernel", ["plane", "edges"])
def test_bf16_accumulation_ablation(n, p, kernel):
    """``mix_in_float32=False`` on a bf16 plane.  The port rounds C, every
    product and every partial sum to bf16 in ascending source order; the
    reference's edges kernel rounds the same way, while its interpret-mode
    dense ``jnp.dot(..., preferred_element_type=bf16)`` rounds fewer times
    (elementwise the gap is large relative to outputs near 0, where the
    rounded partial sums cancel).  Measured on these inputs: edges
    bit-identical; dense at most 1 bf16 ulp of max|out|.  Pinned: edges
    exact, dense ≤ 2 bf16 ulps of max|out|."""
    plane, c, idx, msk = _inputs(n, p, 3 * n + p)
    pj = jnp.asarray(plane).astype(jnp.bfloat16)
    pt = torch.as_tensor(plane).to(torch.bfloat16)
    if kernel == "plane":
        ref = gossip_plane_pallas(pj, jnp.asarray(c), mix_in_float32=False)
        out = tk.gossip_plane(pt, torch.as_tensor(c), mix_in_float32=False)
    else:
        ref = _jax_edges(pj, c, idx, msk, f32=False)
        out = _port_edges(pt, c, idx, msk, f32=False)
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    if kernel == "edges":
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 2 * _bf16_ulp(np.abs(ref).max())
    # the ablation really accumulates in bf16: it differs from f32 sums
    f32_sum = tk.gossip_plane(pt, torch.as_tensor(c)).float().numpy()
    if n >= 8:
        assert not np.array_equal(
            tk.gossip_plane(pt, torch.as_tensor(c), False).float().numpy(),
            f32_sum)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_edges_equals_dense_to_1e6(n):
    """The reference's own claim (tests/test_mix_equivalence.py) carried
    over: the edge-list mix equals the dense mix to 1e-6."""
    rng = np.random.default_rng(n)
    plane, c, idx, msk = _inputs(n, 513, n)
    tree = {"a": torch.as_tensor(rng.normal(size=(n, 3, 5)), dtype=torch.float32),
            "b": [torch.as_tensor(plane), torch.zeros(n)]}
    ct = torch.as_tensor(c)
    dense = mix_dense(tree, ct)
    for mixed in (mix_edges(tree, ct, torch.as_tensor(idx), torch.as_tensor(msk)),
                  tk.mix_edges_kernel(tree, ct, torch.as_tensor(idx),
                                      torch.as_tensor(msk)),
                  tk.mix_plane(tree, ct)):
        for a, b in zip([mixed["a"], *mixed["b"]], [dense["a"], *dense["b"]]):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(
        tk.gossip_edges(torch.as_tensor(plane),
                        edge_weights(ct, torch.as_tensor(idx),
                                     torch.as_tensor(msk)),
                        torch.as_tensor(idx)).numpy(),
        (ct @ torch.as_tensor(plane)).numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    plane, c, idx, msk = _inputs(8, 64, 0)
    before = (tk.gossip_plane.launches, tk.gossip_edges.launches)
    tk.gossip_plane(torch.as_tensor(plane), torch.as_tensor(c))
    _port_edges(torch.as_tensor(plane), c, idx, msk)
    assert (tk.gossip_plane.launches, tk.gossip_edges.launches) == before


def test_wrappers_check_shapes_and_dtypes():
    plane = torch.zeros(4, 9)
    with pytest.raises(ValueError, match="coeffs"):
        tk.gossip_plane(plane, torch.zeros(3, 3))
    with pytest.raises(TypeError, match="dtype"):
        tk.gossip_plane(plane.double(), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="dmax"):
        tk.gossip_edges(plane, torch.zeros(4, 2), torch.zeros(4, 3,
                                                              dtype=torch.int32))
