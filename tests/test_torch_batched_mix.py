"""The gossip kernels' experiment axis: E experiments mixed at once.

On the CPU the batched plain versions (``gossip_plane_ref``,
``gossip_edges_ref``, ``gossip_robust_ref``) and every batched tree mix
(``make_mix_fn``'s backends with ``(E, n, ...)`` trees and ``(E, n, n)``
matrices) equal E unbatched calls bit for bit, and ``jax.vmap`` of the
reference's Pallas kernels (interpret mode) to the tolerances of the
unbatched parity tests (``test_torch_mix.py``, ``test_torch_robust.py``).
The ``cuda`` tests hold each batched kernel launch against E single
launches bit for bit on the card, NaN and ±Inf rows included; they skip
here.  JAX is imported only by the test that needs it, so the ``cuda``
tests run on a card without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_batched_mix.py
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.core import topology as ttopo
from repro_torch.core.coeffs import (
    participation_renormalize,
    quarantine_renormalize,
)
from repro_torch.core.decentralized import edges_schedule, make_mix_fn
from repro_torch.core.mixing import edge_weights, norm_clip_coeffs, plane_norms
from repro_torch.core.plane import PlaneLayout
from repro_torch.kernels import gossip_mix as tk

torch.set_num_threads(2)

E = 3


def _grid(n, p, seed, nonfinite=0.0):
    """E planes ``(E, n, P)`` as one folded allocation, E row-stochastic
    matrices on BA(n, 2) + I, the shared tables, the per-experiment
    weights."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(E, n, p)).astype(np.float32)
    if nonfinite:
        bad = rng.random(planes.shape) < nonfinite
        planes[bad] = rng.choice([np.nan, np.inf, -np.inf], size=bad.sum())
    topo = ttopo.barabasi_albert(n, 2, seed)
    sup = (topo.adjacency + np.eye(n)).astype(np.float32)
    c = rng.random((E, n, n)).astype(np.float32) * sup
    c = (c / c.sum(-1, keepdims=True)).astype(np.float32)
    idx, msk = edges_schedule(sup)
    w = edge_weights(torch.as_tensor(c), torch.as_tensor(idx),
                     torch.as_tensor(msk))
    return planes, c, idx.astype(np.int32), msk, w


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f32", [True, False])
def test_batched_plain_versions_equal_single_calls(dtype, f32):
    planes, c, idx, _, w = _grid(9, 301, 1, nonfinite=0.02)
    pt = torch.as_tensor(planes).to(dtype)
    ct, it = torch.as_tensor(c), torch.as_tensor(idx)
    finite = torch.nan_to_num(pt, nan=0.0, posinf=0.0, neginf=0.0)
    outs = {
        "plane": (tk.gossip_plane(finite, ct, f32),
                  [tk.gossip_plane(finite[e], ct[e], f32) for e in range(E)]),
        "edges": (tk.gossip_edges(finite, w, it, f32),
                  [tk.gossip_edges(finite[e], w[e], it, f32)
                   for e in range(E)]),
    }
    for op, k in (("trimmed", 1), ("median", 0)):
        outs[op] = (tk.gossip_robust(pt, w, it, op, k, f32),
                    [tk.gossip_robust(pt[e], w[e], it, op, k, f32)
                     for e in range(E)])
    for name, (got, singles) in outs.items():
        assert got.dtype == dtype and tuple(got.shape) == tuple(pt.shape)
        for e in range(E):
            assert _same(got[e].float(), singles[e].float()), (name, e)


@pytest.mark.parametrize("n,p", [(5, 37), (12, 1000)])
def test_batched_plain_versions_match_vmapped_pallas(n, p):
    """Against ``jax.vmap`` of the reference kernels over E (interpret
    mode), to the unbatched tests' pins: plane and edges rtol = atol =
    1e-6, median exact, trimmed rtol = atol = 1e-6 (measured here, max
    abs err: plane 0, edges 2.4e-7, trimmed 2.4e-7, median 0)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.gossip_mix import (
        gossip_edges_pallas,
        gossip_plane_pallas,
        gossip_robust_pallas,
    )

    planes, c, idx, msk, w = _grid(n, p, n + p, nonfinite=0.0)
    pj, cj, wj, ij = (jnp.asarray(planes), jnp.asarray(c),
                      jnp.asarray(w.numpy()), jnp.asarray(idx))
    pt, ct, it = (torch.as_tensor(planes), torch.as_tensor(c),
                  torch.as_tensor(idx))
    want = jax.vmap(gossip_plane_pallas)(pj, cj)
    np.testing.assert_allclose(tk.gossip_plane(pt, ct).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jax.vmap(lambda a, b: gossip_edges_pallas(a, b, ij))(pj, wj)
    np.testing.assert_allclose(tk.gossip_edges(pt, w, it).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    for op, k in (("trimmed", 1), ("median", 0)):
        want = jax.vmap(lambda a, b: gossip_robust_pallas(
            a, b, ij, op=op, trim_k=k))(pj, wj)
        got = tk.gossip_robust(pt, w, it, op, k).numpy()
        if op == "median":
            assert _same(got, want)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-6)


def _tree(planes):
    """An FFN-like tree with leaves ``(E, n, ...)`` from ``(E, n, P)``."""
    e, n, _ = planes.shape
    t = torch.as_tensor(planes)
    return {"b": t[:, :, :7].clone(),
            "w": t[:, :, 7:7 + 4 * 5].reshape(e, n, 4, 5).clone()}


@pytest.mark.parametrize("impl,robust", [
    ("einsum", "mean"), ("pallas", "mean"), ("edges", "mean"),
    ("sparse", "mean"), ("einsum", "trimmed"), ("edges", "trimmed"),
    ("edges", "median"), ("pallas", "norm_clip"), ("einsum", "norm_clip")])
def test_batched_tree_mixes_equal_single_calls(impl, robust):
    """``make_mix_fn`` with a sweep's operands equals each experiment's
    own call bit for bit, for every backend and rule (the kernels' plain
    versions on the CPU)."""
    planes, c, _, _, _ = _grid(8, 30, 4)
    sup = np.maximum(ttopo.barabasi_albert(8, 2, 4).adjacency, np.eye(8))
    mix = make_mix_fn(impl, mix_support=sup, robust=robust,
                      robust_clip=0.5, device="cpu")
    params = _tree(planes)
    ct = torch.as_tensor(c)
    got = mix(params, ct)
    for e in range(E):
        one = mix(tree_util.tree_map(lambda x: x[e], params), ct[e])
        for a, b in zip(tree_util.leaves(got), tree_util.leaves(one)):
            assert torch.equal(a[e], b), (impl, robust, e)


def test_batched_kernel_mixes_pack_once_and_launch_once():
    """The tree wrappers fold E into the node axis and pack ONE plane:
    the gossip wrappers see ``(E, n, P)`` views of one ``(E·n, ld)``
    allocation."""
    planes, c, idx, msk, _ = _grid(6, 27, 2)
    params = _tree(planes)
    seen = []
    orig = tk.gossip_plane

    def spy(plane, coeffs, f32=True):
        seen.append((tuple(plane.shape), plane.stride()))
        return orig(plane, coeffs, f32)

    tk.gossip_plane = spy
    try:
        tk.mix_plane(params, torch.as_tensor(c))
    finally:
        tk.gossip_plane = orig
    layout = PlaneLayout.from_tree(
        tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), params))
    assert len(seen) == 1
    shape, stride = seen[0]
    assert shape == (E, 6, layout.n_params)
    assert stride[0] == 6 * stride[1] and stride[2] == 1


def test_batched_coefficient_transforms_equal_single_calls():
    planes, c, _, _, _ = _grid(7, 40, 5)
    ct = torch.as_tensor(c)
    rng = np.random.default_rng(0)
    mask = torch.as_tensor(rng.random((E, 7)) < 0.6)
    params = _tree(planes)
    norms = plane_norms(params, 2)
    assert norms.shape == (E, 7)
    for fn, arg in ((participation_renormalize, mask),
                    (quarantine_renormalize, mask),
                    (lambda a, b: norm_clip_coeffs(a, b, 0.7), norms)):
        got = fn(ct, arg)
        for e in range(E):
            assert torch.equal(got[e], fn(ct[e], arg[e]))
    for e in range(E):
        assert torch.equal(norms[e], plane_norms(
            tree_util.tree_map(lambda x: x[e], params)))


def test_batched_operands_are_checked():
    planes, c, idx, _, w = _grid(5, 10, 0)
    pt = torch.as_tensor(planes)
    with pytest.raises(ValueError, match="coeffs must be"):
        tk.gossip_plane(pt, torch.as_tensor(c[0]))
    with pytest.raises(ValueError, match="weights must be"):
        tk.gossip_edges(pt, w[0], torch.as_tensor(idx))
    with pytest.raises(ValueError, match="nbr_idx"):
        tk.gossip_robust(pt, w, torch.as_tensor(np.stack([idx] * E)))
    with pytest.raises(ValueError, match="plane must be"):
        tk.gossip_plane(pt[None], torch.as_tensor(c))


# ----------------------------------------------------------------------
# on the card: a batched launch == E single launches, bit for bit
# ----------------------------------------------------------------------
def _card_grid(n, p, seed, dtype, nonfinite=0.0):
    planes, c, idx, msk, w = _grid(n, p, seed, nonfinite)
    layout_plane = torch.empty((E * n, -(-p // 8) * 8), dtype=dtype,
                               device="cuda")[:, :p]
    layout_plane.copy_(torch.as_tensor(planes).reshape(E * n, p))
    return (layout_plane.unflatten(0, (E, n)), torch.as_tensor(c).cuda(),
            torch.as_tensor(idx).cuda(), w.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("n,p", [(5, 37), (33, 1001), (33, 200_003),
                                 (70, 515)])
def test_batched_kernels_equal_single_launches_on_the_card(dtype, f32, n, p):
    """``stream_kernel``, ``edges_kernel`` and ``robust_kernel`` with E
    experiments on the grid's y axis against E launches of one experiment
    each: max abs err 0 (NaN/±Inf rows through the robust rules), and the
    batched launch counted once under an ``"E=3"`` shape key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plane, c, idx, w = _card_grid(n, p, n, dtype)
    bad, _, _, _ = _card_grid(n, p, n, dtype, nonfinite=0.02)
    cases = [("plane", lambda q, e: tk.gossip_plane(
                  q, c if e is None else c[e], f32), plane),
             ("edges", lambda q, e: tk.gossip_edges(
                  q, w if e is None else w[e], idx, f32), plane)]
    if n <= 64:
        for op, k in (("trimmed", 1), ("median", 0)):
            cases.append((op, lambda q, e, op=op, k=k: tk.gossip_robust(
                q, w if e is None else w[e], idx, op, k, f32), bad))
    for name, fn, q in cases:
        counter = {"plane": tk.gossip_plane, "edges": tk.gossip_edges}.get(
            name, tk.gossip_robust)
        before = counter.launches
        got = fn(q, None)
        assert counter.launches == before + 1
        assert any(key[0] == f"E={E}" for key in counter.shapes), name
        for e in range(E):
            one = fn(q[e], e)
            torch.cuda.synchronize()
            assert _same(got[e].float().cpu(), one.float().cpu()), (name, e)


@pytest.mark.cuda
def test_batched_edges_kernel_traps_per_experiment_on_the_card():
    """The table check stays ``j in [0, n)`` within each experiment: a
    table index pointing into the next experiment's rows (n) is refused
    with a trap, as in the single launch, even though those rows exist in
    the allocation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import subprocess
    import sys
    code = (
        "import torch, numpy as np\n"
        "from repro_torch.kernels import gossip_mix as tk\n"
        "p = torch.zeros((2, 4, 16), device='cuda')\n"
        "w = torch.ones((2, 4, 1), device='cuda')\n"
        "idx = torch.full((4, 1), 4, dtype=torch.int32, device='cuda')\n"
        "tk.gossip_edges(p, w, idx)\n"
        "torch.cuda.synchronize()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_lm_gather_round_batch_on_the_card(batched):
    """The sweep engine's gather of a round's LM batches from a token bank
    on the card equals ``NodeBatcher.round_batches``, the all-ones next-
    token mask included, in the ``(n, S)`` and the ``(E, n, S)`` index
    forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.sweep import gather_round_batch
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher
    from repro_torch.data.synthetic import make_dataset

    nb = NodeBatcher(node_datasets(make_dataset("tinymem", 600, seed=0), 8,
                                   ood_node=1, seed=0),
                     8, steps_per_epoch=3, local_epochs=2)
    bank = {k: torch.as_tensor(v[None]).cuda()
            for k, v in nb.sample_bank().items()}
    idx = torch.as_tensor(nb.all_round_indices(2)).cuda()
    for r in range(2):
        want = nb.round_batches(r)
        if batched:
            got = gather_round_batch(bank, torch.zeros(E, dtype=torch.long,
                                                       device="cuda"),
                                     idx[r].expand(E, -1, -1), 8)
            got = {k: v[E - 1] for k, v in got.items()}
        else:
            got = gather_round_batch(bank, torch.tensor(0, device="cuda"),
                                     idx[r], 8)
        assert set(got) == set(want) == {"tokens", "mask"}
        for k in want:
            assert got[k].device.type == "cuda"
            assert got[k].dtype == torch.as_tensor(want[k]).dtype
            assert _same(got[k].cpu().numpy(), want[k]), k
