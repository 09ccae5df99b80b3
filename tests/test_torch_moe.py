"""Port parity for the MoE block (``repro_torch/models/moe.py``) and the
MoE branches of the transformer stack, held against the JAX package on
the llama4-scout (16 → 4 experts, top-1, one shared) and deepseek-v2
(MLA, 160 → 4 experts, top-2, one shared, a dense first layer) smoke
configs in f32: ``moe_apply`` with its drop masks, a fleet against its
single nodes, ``forward``/``decode_step``, the ``FleetScheduler``, one
``make_train_step`` step, and the parameter trees of the card's cuts.
JAX weights come over through ``params_from_jax``; inputs are made from
a seed with numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.registry import get_config as jfull
from repro.configs.registry import get_smoke_config as jget
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serving import scheduler as jsched
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import tree as tree_util
from repro_torch.configs.base import ParallelConfig as TParallel
from repro_torch.configs.registry import get_config as tfull
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.interop import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

torch.set_num_threads(2)

ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")


def _configs(arch, **fields):
    jc, tc = jget(arch), tget(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return (dataclasses.replace(jc, **fields),
            dataclasses.replace(tc, **fields))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


_PARAMS = {}


def _params(arch, seed=0):
    """A jitted JAX init of the smoke config and the same weights in the
    port (the capacity factor is no weight: one init serves every
    factor)."""
    key = (arch, seed)
    if key not in _PARAMS:
        jc, _ = _configs(arch)
        jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(seed))
        _PARAMS[key] = jp, params_from_jax(_np(jp), "cpu")
    return _PARAMS[key]


def _moe_params(arch, seed=0):
    """One MoE block's weights: JAX's ``moe_init``, and the port's with a
    node axis of 1."""
    jc, _ = _configs(arch)
    jp = jax.jit(lambda k: jmoe.moe_init(k, jc, jnp.float32))(
        jax.random.key(seed))
    return jp, tt.add_node_axis(params_from_jax(_np(jp), "cpu"))


def _ref_routing(jp, jc, x):
    """The reference's routing of ``x`` ``(B, S, D)``, the lines of
    ``repro/models/moe.py`` ``moe_apply`` up to the slots (moe_apply
    returns only the output and the aux loss): the experts, the keep mask
    and the clipped slots, ``(T, k)`` each."""
    b, s, d = x.shape
    t, e, k = b * s, jc.n_experts, jc.experts_per_token
    cap = int(max(1, round(t * k / e * jc.capacity_factor)))
    cap = (cap + 127) // 128 * 128 if cap > 128 else cap
    probs = jax.nn.softmax(x.reshape(t, d).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(ids, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jnp.max(jnp.cumsum(flat, axis=0) * flat - 1, axis=-1).reshape(t, k)
    return (np.asarray(ids), np.asarray(pos < cap),
            np.asarray(jnp.clip(pos, 0, cap - 1)), cap)


# ----------------------------------------------------------------------
# the block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,get,t,want", [
    ("llama4-scout-17b-a16e", tget, 8, 2),    # 2.5 → 2 (ties to even)
    ("llama4-scout-17b-a16e", tfull, 2, 1),   # 0.156 → 0 → 1
    ("deepseek-v2-236b", tfull, 2, 1),        # 0.094 → 0 → 1
    ("deepseek-v2-236b", tfull, 128, 6),      # a 2 × 64 prompt
    ("deepseek-v2-236b", tfull, 4096, 256),   # 192 → a multiple of 128
    ("llama4-scout-17b-a16e", tfull, 4096, 384),  # 320 → 384
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_capacity_is_the_reference_expression(arch, get, t, want):
    """The capacity at the worked token counts of the smoke (``tget``)
    and full (``tfull``) configs: Python's ``round`` (banker's), at
    least 1, rounded up to a multiple of 128 above 128."""
    assert tmoe.capacity(get(arch), t) == want


# (arch, B, S, capacity_factor): t = 8 hits llama4's banker's 2.5 → 2;
# 0.5 overflows (deepseek: cap 2 for 16 pairs); E / k is dropless; t =
# 512 takes llama4's capacity past 128 (160 → 256)
MOE_CASES = [
    ("llama4-scout-17b-a16e", 2, 4, 1.25),
    ("llama4-scout-17b-a16e", 2, 4, 0.5),
    ("llama4-scout-17b-a16e", 2, 4, 4.0),
    ("llama4-scout-17b-a16e", 4, 128, 1.25),
    ("deepseek-v2-236b", 2, 4, 1.25),
    ("deepseek-v2-236b", 2, 4, 0.5),
    ("deepseek-v2-236b", 3, 1, 1.25),
    ("deepseek-v2-236b", 2, 16, 2.0),
]


@pytest.mark.parametrize("arch,b,s,cf", MOE_CASES)
def test_moe_apply_matches_reference(arch, b, s, cf):
    """``moe_apply`` against the reference's on the same weights and
    input: the experts, the keep mask and the slots exactly; the output
    within 2e-6 of max |ref| (measured at most 5.4e-7) and the aux loss
    within 1e-6 relative (measured at most 9.3e-8)."""
    jc, tc = _configs(arch, capacity_factor=cf)
    jp, tp = _moe_params(arch)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, jc.d_model)).astype(np.float32)
    out, aux = jmoe.moe_apply(jp, jc, jnp.asarray(x))
    got, got_aux = tmoe.moe_apply(tp, tc, torch.as_tensor(x)[None])
    ids, keep, slot, cap = _ref_routing(jp, jc, jnp.asarray(x))
    r = tmoe.route(tp, tc, torch.as_tensor(x).reshape(1, b * s, -1))
    assert r.cap == cap
    np.testing.assert_array_equal(r.expert_ids[0].numpy(), ids)
    np.testing.assert_array_equal(r.keep[0].numpy(), keep)
    np.testing.assert_array_equal(r.slot[0].numpy(), slot)
    if cf == 0.5:
        assert not keep.all()      # the overflow case drops pairs
    if cf == jc.n_experts / jc.experts_per_token:
        assert keep.all()
    ref = np.asarray(out)
    err = float(np.abs(got[0].numpy() - ref).max())
    assert err <= 2e-6 * float(np.abs(ref).max()), err
    assert abs(float(got_aux[0]) - float(aux)) <= 1e-6 * abs(float(aux))


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities take ``jax.lax.top_k``'s order: a zero
    router gives every expert 1/E, and each token's k choices are the
    experts 0..k-1, in that order, as the reference's."""
    jc, tc = _configs("deepseek-v2-236b")
    jp, tp = _moe_params("deepseek-v2-236b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(0).standard_normal((2, 3, jc.d_model)).astype(
        np.float32)
    ids, keep, _, _ = _ref_routing(jp, jc, jnp.asarray(x))
    r = tmoe.route(tp, tc, torch.as_tensor(x).reshape(1, 6, -1))
    np.testing.assert_array_equal(r.expert_ids[0].numpy(), ids)
    np.testing.assert_array_equal(r.keep[0].numpy(), keep)
    assert (ids == np.arange(jc.experts_per_token)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_equals_single_nodes_bit_for_bit(arch):
    """A fleet of 3 nodes (distinct inits) in one ``forward_nodes`` call
    gives each node's logits and aux loss bit for bit as that node alone,
    at a capacity factor of 0.5 where tokens overflow: each node sizes
    its capacity from its own B·S and drops its own tokens.  A capacity
    pooled over the fleet (3 × the tokens) would keep pairs a node alone
    drops."""
    _, tc = _configs(arch, capacity_factor=0.5)
    nodes = [_params(arch, seed)[1] for seed in range(3)]
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *nodes)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab_size, size=(3, 2, 8)).astype(np.int32))
    logits, aux = tt.forward_nodes(stacked, tc, toks)
    assert aux.shape == (3,)
    for i, p in enumerate(nodes):
        one, one_aux = tt.forward_nodes(tt.add_node_axis(p), tc, toks[i:i + 1])
        assert torch.equal(logits[i], one[0]), i
        assert torch.equal(aux[i], one_aux[0]), i
    x = torch.randn(3, 2, 8, tc.d_model, generator=torch.Generator()
                    .manual_seed(0))
    lp = tt._layer(stacked["moe_layers"], 0)["moe"]
    r = tmoe.route(lp, tc, x.reshape(3, 16, -1))
    assert r.cap == tmoe.capacity(tc, 16) and not bool(r.keep.all())


# ----------------------------------------------------------------------
# the stack
# ----------------------------------------------------------------------
@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    """``forward`` of both smoke configs (llama4: two MoE layers, no
    ``dense_layers``; deepseek-v2: a dense layer, then a MoE layer) on
    the same weights and tokens: logits within 1e-5 (measured at most
    4.7e-6 at |logit| up to 3.9), the aux loss within 1e-6 relative
    (measured at most 1.6e-7)."""
    jc, tc = _configs(arch)
    jp, tp = _params(arch)
    assert ("dense_layers" in tp) == (arch == "deepseek-v2-236b")
    assert set(tp["moe_layers"]) == {"norm1", "norm2", "attn", "moe"}
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, size=(2, 16)).astype(np.int32)
    ref, jaux = jt.forward(jp, jc, {"tokens": jnp.asarray(toks)},
                           jt.ForwardOptions(attn_impl=impl, remat=False))
    out, aux = tt.forward(tp, tc, {"tokens": torch.as_tensor(toks)},
                          tt.ForwardOptions(attn_impl=impl))
    assert aux.shape == ()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def _decode_all(step, params, cfg, toks, cache):
    outs = []
    for i in range(toks.shape[1]):
        logits, cache = step(params, cfg, toks[:, i:i + 1], cache)
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, 1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """12 cached decode steps of 3 lanes, each step's MoE routing the 3
    tokens with the reference's capacity (llama4: 1, deepseek-v2: 2 for
    6 pairs, so pairs drop): logits within 1e-5 (measured at most
    4.2e-6), the caches within 1e-5 (measured 3.2e-6), positions
    exactly.  The cache stays stacked over both layers."""
    jc, tc = _configs(arch)
    jp, tp = _params(arch)
    toks = np.random.default_rng(2).integers(
        0, jc.vocab_size, size=(3, 12)).astype(np.int32)
    ref, jcache = _decode_all(jax.jit(jt.decode_step, static_argnums=1), jp,
                              jc, jnp.asarray(toks),
                              jt.init_cache(jc, 3, 16))
    out, cache = _decode_all(tt.decode_step, tp, tc, torch.as_tensor(toks),
                             tt.init_cache(tc, 3, 16, device="cpu"))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    for k, v in jcache.items():
        assert tuple(cache[k].shape) == v.shape and v.shape[0] in (3, 2), k
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5)


def _serve(mod, cfg, stacked, n, work):
    fleet = mod.FleetScheduler(cfg, stacked, n_nodes=n, n_slots=2,
                               max_seq=48)
    reqs = [mod.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for i, r in enumerate(reqs):
        fleet.submit(r, node=i % n)
    steps = fleet.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], steps


@pytest.mark.parametrize("cf", ["dropless", 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_scheduler_matches_reference(arch, cf):
    """The port's ``FleetScheduler`` emits token for token what the JAX
    one emits for the same 7 requests on three nodes (distinct inits),
    in as many fleet steps: at a dropless capacity factor (E / k) and at
    the published 1.25, where each step's MoE routes every lane of a
    node (idle lanes included) and drops pairs past the capacity."""
    e_over_k = jget(arch).n_experts / jget(arch).experts_per_token
    jc, tc = _configs(arch, capacity_factor=e_over_k if cf == "dropless"
                      else cf)
    n = 3
    jps, tps = zip(*(_params(arch, s) for s in range(n)))
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    tstack = tree_util.tree_map(lambda *xs: torch.stack(xs), *tps)
    rng = np.random.default_rng(5)
    work = [(rng.integers(1, jc.vocab_size,
                          size=int(rng.integers(1, 18))).tolist(),
             int(rng.integers(1, 12))) for _ in range(7)]
    want, jsteps = _serve(jsched, jc, jstack, n, work)
    got, steps = _serve(tsched, tc, tstack, n, work)
    assert got == want
    assert steps == jsteps


def test_decode_lanes_share_the_capacity_as_the_reference():
    """The reference's semantics under capacity routing, kept: a decode
    step routes every lane of a node together, so one lane's token can
    push another's pair out of its expert.  On llama4's smoke config
    (cap 1 for 2 lanes), the lane-1 logits of a step depend on lane 0's
    token (16 tokens tried; the port within 1e-5 of the reference's
    logits in each), and alone (B = 1) the lane gets what it gets beside
    a lane 0 routed to another expert (ROADMAP Queue 3)."""
    jc, tc = _configs("llama4-scout-17b-a16e")
    jp, tp = _params("llama4-scout-17b-a16e")
    outs = {}
    step = jax.jit(jt.decode_step, static_argnums=1)
    for first in range(0, jc.vocab_size, 16):
        toks = np.array([[first], [7]], np.int32)
        j, _ = step(jp, jc, jnp.asarray(toks), jt.init_cache(jc, 2, 4))
        t, _ = tt.decode_step(tp, tc, torch.as_tensor(toks),
                              tt.init_cache(tc, 2, 4, device="cpu"))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
        outs[first] = t[1, 0].numpy()
    lane1 = np.stack(list(outs.values()))
    assert float(np.ptp(lane1, axis=0).max()) > 1e-3   # lane 0 moved lane 1
    alone, _ = tt.decode_step(tp, tc, torch.tensor([[7]], dtype=torch.int32),
                              tt.init_cache(tc, 1, 4, device="cpu"))
    assert any(np.allclose(alone[0, 0].numpy(), v, rtol=0, atol=1e-5)
               for v in outs.values())


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def test_make_train_step_matches_reference():
    """One ``make_train_step`` step (SGD 0.1, no gossip) on llama4's smoke
    config at n = 2 nodes (distinct inits), 2 microbatches of 2 × 12
    tokens a node, through ``vmap(grad_and_value)``: the loss, aux
    included, within 1e-5 (measured 9.5e-7 at 6.02); every param after
    the step within 2e-7 (measured at most 1.5e-7, one ulp of the
    embedding); the router and the experts move, each within 2e-4 of its
    largest step (measured at most 8.6e-5: one ulp of weights up to 1.5
    against steps of 1.4e-3; the router 3.2e-5)."""
    arch, n, micro = "llama4-scout-17b-a16e", 2, 2
    jc, tc = _configs(arch)
    jps, tps = zip(*(_params(arch, s) for s in range(n)))
    jpar = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    tpar = tree_util.tree_map(lambda *xs: torch.stack(xs), *tps)
    jpc, tpc = (JParallel(n_nodes=n, microbatch=micro),
                TParallel(n_nodes=n, microbatch=micro))
    jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    jstep = jax.jit(jts.make_train_step(jc, jpc, jo, gossip=False))
    tstep = tts.make_train_step(tc, tpc, to, gossip=False)
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, size=(n * micro * 2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = jts.reshape_for_microbatch(jax.tree.map(jnp.asarray, batch), n,
                                    micro)
    tb = tts.reshape_for_microbatch(
        tree_util.tree_map(torch.as_tensor, batch), n, micro)
    jnew, _, jl = jstep(jpar, jax.vmap(jo.init)(jpar), jb,
                        jnp.eye(n, dtype=jnp.float32))
    tnew, _, tl = tstep(tpar, to.init(tpar), tb, torch.eye(n))
    assert abs(float(tl) - float(jl)) <= 1e-5, (float(tl), float(jl))
    moved = []
    for (path, a), b, old in zip(tree_util.leaves_with_paths(tnew),
                                 jax.tree.leaves(jnew),
                                 jax.tree.leaves(jpar)):
        ref, old = np.asarray(b), np.asarray(old)
        err = float(np.abs(a.numpy() - ref).max())
        assert err <= 2e-7, (path, err)
        if "router" in path or "experts" in path:
            step = float(np.abs(ref - old).max())
            assert step > 0 and err <= 2e-4 * step, (path, err, step)
            moved.append(path[-1])
    assert sorted(moved) == ["router", "wg", "wi", "wo"]


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------
# (arch, layers): the card's cuts, each the reference's tree
CHIP_CUTS = {
    "deepseek-v2-236b": (2, 35, 5_358_679_040),
    "llama4-scout-17b-a16e": (1, 18, 4_271_078_656),
}


@pytest.mark.parametrize("arch", sorted(CHIP_CUTS))
def test_chip_cut_trees_match_the_reference(arch, monkeypatch):
    """The full-width cuts ``chip_smoke.py`` phase 16 serves (deepseek-v2
    at 2 layers: the dense first layer and a MoE layer; llama4-scout at 1
    MoE layer) have the reference's tree (``jax.eval_shape``, no draw):
    the same leaves, shapes and dtypes — the router f32 in a bf16 tree —
    and the parameter counts ``chip_smoke.py`` pins.  The port's init
    runs with its draws stubbed to empty tensors."""
    layers, n_leaves, count = CHIP_CUTS[arch]
    jc = dataclasses.replace(jfull(arch), n_layers=layers)
    tc = dataclasses.replace(tfull(arch), n_layers=layers)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                            jax.random.key(0))
    empty = lambda gen, shape, dtype, scale=None, stacked=0: torch.empty(
        tuple(shape), dtype=dtype)
    monkeypatch.setattr(tt, "dense_init_on_device", empty)
    monkeypatch.setattr(tmoe, "dense_init_on_device", empty)
    import repro_torch.models.layers as tlayers
    monkeypatch.setattr(tlayers, "dense_init_on_device", empty)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        tp) == jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), shapes)
    leaves = tree_util.leaves(tp)
    assert len(leaves) == n_leaves
    assert sum(t.numel() for t in leaves) == count
    assert tp["moe_layers"]["moe"]["router"].dtype == torch.float32


def test_expert_init_has_the_reference_std():
    """The experts' std is 1/√E (the reference's ``dense_init`` takes the
    fan-in from ``shape[0]`` of ``(E, d, fe)``), the router's 1/√d:
    both within 2% of the truncated normal's std times that scale
    (measured within 0.4%), as the reference's own draw."""
    jc, tc = _configs("llama4-scout-17b-a16e", d_model=512, n_experts=64)
    jp = jax.jit(lambda k: jmoe.moe_init(k, jc, jnp.float32))(
        jax.random.key(0))
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tc, torch.float32, 1)
    trunc = 0.9865811892       # std of a normal truncated at ±3σ
    for name, fan_in in (("router", tc.d_model),
                         ("experts/wg", tc.n_experts)):
        a, b = tp, jp
        for part in name.split("/"):
            a, b = a[part], b[part]
        want = trunc / np.sqrt(fan_in)
        for got in (float(a.std()), float(np.asarray(b).std())):
            assert abs(got / want - 1) <= 0.02, (name, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_bf16_moe_tree(arch):
    """A bf16 JAX init of the smoke config comes over through
    ``params_from_jax(..., like=)`` (numpy has no bf16, so as f32): the
    router stays f32 as in the reference's tree, every other leaf bf16,
    and every value equal to the JAX leaf's."""
    jc, tc = _configs(arch, dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(0))
    like = tt.init_params(torch.Generator().manual_seed(0), tc)
    tp = params_from_jax(_np(jp), "cpu", like=like)
    dtypes = {}
    for (path, a), b in zip(tree_util.leaves_with_paths(tp),
                            jax.tree.leaves(jp)):
        assert str(a.dtype)[6:] == str(b.dtype), path
        dtypes[path[-1] == "router"] = a.dtype
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert dtypes == {True: torch.float32, False: torch.bfloat16}


def test_serve_cli_serves_llama4_cut_to_its_first_layer():
    """The serve CLI on llama4-scout's smoke config cut by ``--layers 1``
    (one MoE layer: the all-MoE branch, as phase 16 serves the full
    width on the card): every request gets its tokens."""
    from repro_torch.launch import serve as tserve

    reqs = tserve.main(["--arch", "llama4-scout-17b-a16e", "--smoke",
                        "--layers", "1", "--nodes", "2", "--batch", "2",
                        "--prompt-len", "6", "--new-tokens", "4",
                        "--device", "cpu"])
    assert len(reqs) == 4 and all(len(r.output) == 4 for r in reqs)
