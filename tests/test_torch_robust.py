"""Port parity for robust aggregation (DESIGN.md §16): the port's sort
network, robust combine, robust table mix, plane norms and norm clip
against the JAX functions; the robust kernel's plain version against the
reference's Pallas kernel (interpret mode); both against a float64 numpy
oracle; and the ``make_mix_fn`` dispatch contract.  The CUDA kernel is
held against its plain version on the card in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core.decentralized import make_mix_fn as jmake_mix_fn
from repro.kernels.gossip_mix import gossip_robust_pallas, mix_robust_pallas
from repro_torch.core import mixing as tmix
from repro_torch.core import topology as ttopo
from repro_torch.core.decentralized import edges_schedule, make_mix_fn
from repro_torch.core.strategies import renormalize_rows
from repro_torch.kernels import gossip_mix as tk

torch.set_num_threads(2)

_BIG = 1e30
RULES = [("trimmed", 1), ("trimmed", 2), ("median", 0)]


def _ulps(a, b, bf16=False):
    """Largest distance in units in the last place between a and b, f32
    ulps or (``bf16=True``, for bf16 values held as f32) bf16 ulps; NaN
    must sit in the same places in both."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)

    def ordered(x):
        i = x[keep].view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = int(np.abs(ordered(a) - ordered(b)).max(initial=0))
    return d >> 16 if bf16 else d


def _case(seed, n, p, nonfinite=0.0, isolate=None):
    """(flat, coeffs, nbr_idx, nbr_mask): random symmetric support with
    self-loops, some supported coefficients zeroed (so occupancy is below
    the structural degree), rows normalised."""
    rng = np.random.default_rng(seed)
    sup = rng.random((n, n)) < 0.5
    sup = np.maximum(sup, sup.T)
    np.fill_diagonal(sup, True)
    if isolate is not None:
        sup[isolate, :] = sup[:, isolate] = False
        sup[isolate, isolate] = True
    c = rng.random((n, n)) * sup * (rng.random((n, n)) > 0.2)
    np.fill_diagonal(c, np.diagonal(c) + 0.5)
    c = c / c.sum(1, keepdims=True)
    flat = rng.standard_normal((n, p)).astype(np.float32)
    if nonfinite:
        bad = rng.random((n, p)) < nonfinite
        flat = np.where(bad, rng.choice([np.nan, np.inf, -np.inf],
                                        size=(n, p)).astype(np.float32), flat)
    idx, msk = edges_schedule(sup.astype(np.float64))
    return flat, c.astype(np.float32), idx, msk


def _oracle(flat, c, idx, msk, op, trim_k):
    """Float64 numpy oracle of the robust rule over one (n, p) leaf."""
    flat = np.asarray(flat, np.float64)
    n, p = flat.shape
    out = flat.copy()
    w = c.astype(np.float64)[np.arange(n)[:, None], idx] * msk
    for i in range(n):
        occ = np.nonzero(w[i] > 0)[0]
        vals = np.clip(np.nan_to_num(flat[idx[i, occ]], nan=_BIG, posinf=_BIG,
                                     neginf=-_BIG), -_BIG, _BIG)
        for t in range(p if occ.size else 0):
            order = np.argsort(vals[:, t], kind="stable")
            sv, sw = vals[order, t], w[i, occ][order]
            if op == "median":
                out[i, t] = np.median(sv)
            elif sv.size > 2 * trim_k:
                kw = sw[trim_k:sv.size - trim_k]
                out[i, t] = (kw * sv[trim_k:sv.size - trim_k]).sum() / kw.sum()
    return out


def _port_mix(flat, c, idx, msk, op, k, f32=True):
    return tmix.mix_robust_tables(
        {"x": torch.as_tensor(flat)}, torch.as_tensor(c),
        torch.as_tensor(idx), torch.as_tensor(msk), op, trim_k=k,
        mix_in_float32=f32)["x"]


def _jax_mix(flat, c, idx, msk, op, k, f32=True):
    return jmix.mix_robust_tables(
        {"x": jnp.asarray(flat)}, jnp.asarray(c), jnp.asarray(idx),
        jnp.asarray(msk), op, trim_k=k, mix_in_float32=f32)["x"]


def _port_kernel_plain(flat_t, c, idx, msk, op, k, f32=True):
    w = tmix.edge_weights(torch.as_tensor(c), torch.as_tensor(idx),
                          torch.as_tensor(msk))
    return tk.gossip_robust(flat_t, w, torch.as_tensor(idx), op, k, f32)


def _jax_kernel(flat_j, c, idx, msk, op, k, f32=True):
    w = jnp.asarray(c)[jnp.arange(c.shape[0])[:, None], idx] * msk
    return gossip_robust_pallas(flat_j, w, jnp.asarray(idx), op=op, trim_k=k,
                                mix_in_float32=f32)


# ----------------------------------------------------------------------
# the building blocks against the JAX functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 5, 8, 15])
def test_oddeven_sort_pairs_matches_jax(d):
    """Keys with ties and signed zeros: the same stable order, exactly."""
    rng = np.random.default_rng(d)
    keys = rng.integers(-3, 4, size=(d, 6, 7)).astype(np.float32)
    keys[keys == 0] = np.where(rng.random((keys == 0).sum()) < 0.5, -0.0, 0.0)
    vals = rng.standard_normal((d, 6, 7)).astype(np.float32)
    jk, jv = jmix.oddeven_sort_pairs(jnp.asarray(keys), jnp.asarray(vals))
    tk_, tv = tmix.oddeven_sort_pairs(torch.as_tensor(keys),
                                      torch.as_tensor(vals))
    assert np.array_equal(tk_.numpy().view(np.uint32),
                          np.asarray(jk).view(np.uint32))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert (np.diff(tk_.numpy(), axis=0) >= 0).all()


@pytest.mark.parametrize("op,trim_k", RULES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_robust_combine_matches_jax(op, trim_k, dtype):
    """The same gathered slab through both ``robust_combine``s.  Measured,
    f32: 0 ulps apart for every rule (the reference's XLA reduction over
    the slot axis runs in ascending order here too).  bf16: the median is
    exact; the trimmed sums differ by up to 2^-8 (one bf16 ulp near 1),
    because the port rounds every partial sum to bf16 (the kernel's
    arithmetic) and XLA sums bf16 in f32 and rounds once.  Pinned: median
    exact; trimmed ≤ 2 ulps in f32, within 2^-7 relative/absolute in
    bf16."""
    rng = np.random.default_rng(len(op) + trim_k)
    vals = rng.standard_normal((9, 7, 11)).astype(np.float32)
    vals[2, 3] = np.nan
    vals[4, 1, :5] = np.inf
    w = rng.random((9, 7)).astype(np.float32) * (rng.random((9, 7)) > 0.3)
    w[:, 5] = 0.0                       # a destination with no slot
    own = rng.standard_normal((7, 11)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = jmix.robust_combine(jnp.asarray(vals).astype(jdt),
                            jnp.asarray(w).astype(jdt),
                            jnp.asarray(own).astype(jdt), op, trim_k)
    t = tmix.robust_combine(torch.as_tensor(vals).to(tdt),
                            torch.as_tensor(w).to(tdt),
                            torch.as_tensor(own).to(tdt), op, trim_k)
    j = np.asarray(j.astype(jnp.float32))
    t = t.float().numpy()
    assert np.array_equal(t[5], j[5])   # no slot: the own row
    if op == "median":
        assert np.array_equal(t, j, equal_nan=True)
    elif dtype == "float32":
        assert _ulps(t, j) <= 2
    else:
        np.testing.assert_allclose(t, j, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("op,trim_k", RULES)
@pytest.mark.parametrize("seed,n,p,nonfinite",
                         [(0, 10, 6, 0.0), (3, 8, 5, 0.15), (7, 16, 33, 0.0)])
def test_mix_robust_tables_matches_jax_and_oracle(op, trim_k, seed, n, p,
                                                  nonfinite):
    """Measured: the port equals the JAX reference bit for bit on every
    case here (0 ulps); both are within 1.6e-7 of the float64 oracle on
    finite inputs.  Pinned: median exact, trimmed ≤ 2 ulps; the oracle to
    the reference test's own rtol 2e-5 / atol 1e-5."""
    flat, c, idx, msk = _case(seed, n, p, nonfinite)
    got = _port_mix(flat, c, idx, msk, op, trim_k).numpy()
    want = np.asarray(_jax_mix(flat, c, idx, msk, op, trim_k))
    if op == "median":
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert _ulps(got, want) <= 2
    if not nonfinite:
        np.testing.assert_allclose(got, _oracle(flat, c, idx, msk, op, trim_k),
                                   rtol=2e-5, atol=1e-5)


def test_plane_norms_and_norm_clip_match_jax():
    """``plane_norms`` sums leaf by leaf like the reference: measured
    8.9e-8 relative; pinned rtol 1e-6.  ``norm_clip_coeffs``
    on the same norms: measured ≤ 6e-8 absolute (the row sums of the
    renormalisation run in another order); pinned 1e-7, and rows that
    nothing clipped are bit-identical."""
    rng = np.random.default_rng(2)
    topo = ttopo.barabasi_albert(10, 2, 4)
    c = rng.random((10, 10)) * (topo.adjacency + np.eye(10))
    c = (c / c.sum(1, keepdims=True)).astype(np.float32)
    tree = {"w": rng.standard_normal((10, 6, 4)).astype(np.float32),
            "b": rng.standard_normal((10, 5)).astype(np.float32)}
    tree["w"][3] *= 50.0
    jn = np.asarray(jmix.plane_norms({k: jnp.asarray(v)
                                      for k, v in tree.items()}))
    tn = tmix.plane_norms({k: torch.as_tensor(v) for k, v in tree.items()})
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6)
    for norms in (jn, np.where(np.arange(10) == 4, np.nan, jn)):
        norms = norms.astype(np.float32)
        jc = np.asarray(jmix.norm_clip_coeffs(jnp.asarray(c),
                                              jnp.asarray(norms), 1.0))
        tc = tmix.norm_clip_coeffs(torch.as_tensor(c),
                                   torch.as_tensor(norms), 1.0).numpy()
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-7)
        untouched = (jc == c).all(1)
        assert untouched.any() and np.array_equal(tc[untouched], c[untouched])
    np.testing.assert_array_equal(
        tmix.norm_clip_coeffs(torch.as_tensor(c),
                              torch.full((10,), 2.0)).numpy(), c)


def test_renormalize_rows_matches_reference_rule():
    from repro.core.strategies import renormalize_rows as jrenorm

    c = np.array([[0.2, 0.0, 0.3], [0.0, 0.0, 0.0], [0.1, 0.1, 0.1]],
                 np.float32)
    want = jrenorm(c)
    assert np.array_equal(renormalize_rows(c), want)
    assert np.array_equal(renormalize_rows(torch.as_tensor(c)).numpy(), want)
    with pytest.raises(ValueError, match="masking bug"):
        renormalize_rows(np.array([[1e-12, 0.0], [0.5, 0.5]]))


# ----------------------------------------------------------------------
# the robust kernel's plain version against the Pallas kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("op,trim_k", RULES)
@pytest.mark.parametrize("n,p", [(4, 7), (9, 300), (16, 1029)])
def test_plain_version_matches_pallas_kernel(op, trim_k, n, p):
    """f32 planes with 5% NaN/±Inf.  Measured: median exact; trimmed up
    to 2.4e-7 apart on finite values and 1.2e-7 relative where a ±1e30
    key survives the trim — the Pallas kernel sums over its padded slot
    count in another order, while the port equals the JAX reference
    ``mix_robust_tables`` bit for bit.  Pinned: median exact, trimmed
    rtol = atol = 1e-6, and the port == the JAX reference exactly."""
    flat, c, idx, msk = _case(n + p, n, p, nonfinite=0.05)
    got = _port_kernel_plain(torch.as_tensor(flat), c, idx, msk, op,
                             trim_k).numpy()
    want = np.asarray(_jax_kernel(jnp.asarray(flat), c, idx, msk, op, trim_k))
    if op == "median":
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, np.asarray(_jax_mix(flat, c, idx, msk, op,
                                                   trim_k)), equal_nan=True)


@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("median", 0)])
@pytest.mark.parametrize("f32", [True, False])
def test_bf16_plain_version_matches_pallas_kernel(op, trim_k, f32):
    """A bf16 plane, f32 or bf16 accumulation.  Measured: median exact;
    trimmed with f32 sums within one bf16 ulp of the output; with bf16
    sums (rounded per partial sum in the port, once in the reference) up
    to 2^-6 apart on finite values and 0.6% relative where a ±1e30 key
    survives the trim.  Pinned: median exact; trimmed one bf16 ulp (f32
    sums) or 2^-5 relative/absolute (bf16 sums)."""
    flat, c, idx, msk = _case(5, 12, 257, nonfinite=0.02)
    pj = jnp.asarray(flat).astype(jnp.bfloat16)
    pt = torch.as_tensor(flat).to(torch.bfloat16)
    got = _port_kernel_plain(pt, c, idx, msk, op, trim_k, f32).float().numpy()
    want = np.asarray(_jax_kernel(pj, c, idx, msk, op, trim_k,
                                  f32).astype(jnp.float32))
    if op == "median":
        assert np.array_equal(got, want, equal_nan=True)
    elif f32:
        assert _ulps(got, want, bf16=True) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -5, atol=2 ** -5)


def test_hypothesis_case_seed0_n4_p2_trimmed():
    """The example Hypothesis recorded against the reference
    (``test_robust_mix.py::test_property_reference_vs_oracle``, seed=0,
    n=4, p=2, trimmed with trim_k=1).  Measured: the port equals the JAX
    reference ``mix_robust_tables`` bit for bit; the JAX Pallas kernel
    differs from both by one ulp at row 3, column 1 (0.17133015 against
    0.17133017); the port is within 1 ulp (7.0e-8) of the float64 oracle."""
    from tests.test_robust_mix import _oracle as jax_oracle
    from tests.test_robust_mix import _random_case

    flat, c, idx, msk = _random_case(0, 4, 2)
    port = _port_mix(flat, c, idx, msk, "trimmed", 1).numpy()
    ref = np.asarray(_jax_mix(flat, c, idx, msk, "trimmed", 1))
    ker = np.asarray(mix_robust_pallas({"x": jnp.asarray(flat)},
                                       jnp.asarray(c), jnp.asarray(idx),
                                       jnp.asarray(msk), op="trimmed",
                                       trim_k=1)["x"])
    oracle = jax_oracle(flat, c, idx, msk, "trimmed", 1)
    assert np.array_equal(port, ref)
    assert _ulps(port, ker) == 1
    assert np.abs(port - oracle).max() <= 7.1e-8
    kernel_plain = _port_kernel_plain(torch.as_tensor(flat), c, idx, msk,
                                      "trimmed", 1).numpy()
    assert np.array_equal(kernel_plain, port)


# ----------------------------------------------------------------------
# degenerate rows
# ----------------------------------------------------------------------
def test_nonfinite_rows_are_outliers_not_contagion():
    """Two NaN/±Inf rows on ring(8): every other node's median and
    trimmed mean (k = 1) stay finite, while the plain mean of a neighbour
    is poisoned; the port equals the JAX reference on the poisoned case."""
    n = 8
    sup = ttopo.ring(n).adjacency + np.eye(n)
    c = (sup / sup.sum(1, keepdims=True)).astype(np.float32)
    idx, msk = edges_schedule(sup)
    flat = np.random.default_rng(3).standard_normal((n, 6)).astype(np.float32)
    flat[0] = np.nan
    flat[4, ::2], flat[4, 1::2] = np.inf, -np.inf
    for op, k in [("median", 0), ("trimmed", 1)]:
        got = _port_mix(flat, c, idx, msk, op, k).numpy()
        assert np.isfinite(np.delete(got, [0, 4], axis=0)).all(), op
        assert np.array_equal(got, np.asarray(_jax_mix(flat, c, idx, msk, op,
                                                       k)), equal_nan=True)
    mean = tmix.mix_edges({"x": torch.as_tensor(flat)}, torch.as_tensor(c),
                          torch.as_tensor(idx), torch.as_tensor(msk))["x"]
    assert not torch.isfinite(mean[1]).all()


def test_all_trimmed_row_keeps_its_own_row_bit_exactly():
    """ring(4): 3 occupied slots per row, trim_k = 2 drops them all, so
    every row falls back to its own raw values (a NaN included)."""
    n = 4
    sup = ttopo.ring(n).adjacency + np.eye(n)
    c = (sup / sup.sum(1, keepdims=True)).astype(np.float32)
    idx, msk = edges_schedule(sup)
    flat = np.random.default_rng(1).standard_normal((n, 5)).astype(np.float32)
    flat[2, 3] = np.nan
    got = _port_mix(flat, c, idx, msk, "trimmed", 2).numpy()
    assert np.array_equal(got, flat, equal_nan=True)
    plain = _port_kernel_plain(torch.as_tensor(flat), c, idx, msk, "trimmed",
                               2).numpy()
    assert np.array_equal(plain, flat, equal_nan=True)


def test_isolated_node_keeps_its_own_row():
    flat, c, idx, msk = _case(4, 6, 4, isolate=2)
    for op, k in [("trimmed", 1), ("median", 0)]:
        got = _port_kernel_plain(torch.as_tensor(flat), c, idx, msk, op,
                                 k).numpy()
        assert np.array_equal(got[2], flat[2]), op
        assert np.array_equal(got, np.asarray(_jax_mix(flat, c, idx, msk, op,
                                                       k)))


@pytest.mark.parametrize("op,trim_k", [("trimmed", 1), ("median", 0)])
@pytest.mark.parametrize("f32", [True, False])
def test_mix_robust_kernel_equals_tables_on_the_cpu(op, trim_k, f32):
    """The tree-level kernel path (pack → plain version → unpack) equals
    the leaf-by-leaf plain mix bit for bit, f32 and bf16 leaves, and a
    CPU call counts no launch."""
    rng = np.random.default_rng(0)
    n = 9
    topo = ttopo.barabasi_albert(n, 2, 1)
    sup = topo.adjacency + np.eye(n)
    c = rng.random((n, n)) * sup
    c = torch.as_tensor(c / c.sum(1, keepdims=True), dtype=torch.float32)
    idx, msk = (torch.as_tensor(a) for a in edges_schedule(sup))
    dt = torch.float32 if f32 else torch.bfloat16
    tree = {"a": torch.as_tensor(rng.standard_normal((n, 3, 4)), dtype=dt),
            "b": [torch.as_tensor(rng.standard_normal((n, 7)), dtype=dt)]}
    before = tk.gossip_robust.launches
    got = tk.mix_robust_kernel(tree, c, idx, msk, op, trim_k, f32)
    want = tmix.mix_robust_tables(tree, c, idx, msk, op, trim_k, f32)
    assert tk.gossip_robust.launches == before
    for a, b in zip([got["a"], *got["b"]], [want["a"], *want["b"]]):
        assert a.dtype == dt and torch.equal(a, b)


# ----------------------------------------------------------------------
# make_mix_fn dispatch
# ----------------------------------------------------------------------
class TestDispatch:
    SUP = ttopo.ring(6).adjacency + np.eye(6)

    def test_mean_returns_plain_backends(self):
        assert make_mix_fn("einsum", robust="mean").func is tmix.mix_dense

    @pytest.mark.parametrize("impl", ["pallas", "sparse"])
    @pytest.mark.parametrize("robust", ["trimmed", "median"])
    def test_sort_rules_reject_unsupported_impls(self, impl, robust):
        with pytest.raises(ValueError, match="no mix_impl"):
            make_mix_fn(impl, mix_support=self.SUP, robust=robust,
                        device="cpu")
        with pytest.raises(ValueError, match="no mix_impl"):
            jmake_mix_fn(impl, mix_support=self.SUP, robust=robust)

    def test_sort_rules_need_support(self):
        with pytest.raises(ValueError, match="mix_support"):
            make_mix_fn("einsum", robust="trimmed", device="cpu")

    def test_unknown_robust_mode(self):
        with pytest.raises(ValueError, match="robust"):
            make_mix_fn("einsum", robust="krum")
        assert tmix.ROBUST_MODES == jmix.ROBUST_MODES

    def test_wrapper_rejects_unknown_op(self):
        with pytest.raises(ValueError, match="op"):
            tk.gossip_robust(torch.zeros(4, 3), torch.zeros(4, 2),
                             torch.zeros(4, 2, dtype=torch.int32), op="krum")

    @pytest.mark.parametrize("robust,k", [("trimmed", 1), ("median", 0),
                                          ("norm_clip", 1)])
    def test_every_impl_matches_the_reference_mix(self, robust, k):
        """Each robust rule through each port backend that serves it,
        against the reference's einsum path on the same inputs: measured
        0 for trimmed and median, 2.4e-7 for norm_clip (rows up to 40x);
        pinned 1e-6."""
        rng = np.random.default_rng(5)
        tree = rng.standard_normal((6, 5, 3)).astype(np.float32)
        tree[0] *= 40.0
        c = (self.SUP / self.SUP.sum(1, keepdims=True)).astype(np.float32)
        want = np.asarray(jmake_mix_fn("einsum", mix_support=self.SUP,
                                       robust=robust, robust_trim=k)(
            {"w": jnp.asarray(tree)}, jnp.asarray(c))["w"])
        impls = (["einsum", "pallas", "edges"] if robust == "norm_clip"
                 else ["einsum", "edges"])
        for impl in impls:
            mix = make_mix_fn(impl, mix_support=self.SUP, robust=robust,
                              robust_trim=k, device="cpu")
            got = mix({"w": torch.as_tensor(tree)}, torch.as_tensor(c))["w"]
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=impl)
