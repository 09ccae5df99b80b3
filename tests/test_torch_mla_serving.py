"""Port parity for serving MLA models: the fleet's prefill and decode
steps and its schedulers against the JAX package's on the same parameters
and requests (``tests/test_serving.py``'s ``MLA`` config with no experts:
2 layers of MLA, the L-stacked latent cache), re-used slots against fresh
decodes, the admission reset (which leaves the latent cache alone, as
K/V), checkpoints and ``params_from_jax`` of the MLA tree, and the serve
CLI on deepseek-v2's smoke config, whose second layer is a MoE layer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.plane import PlaneLayout as JLayout
from repro.models import transformer as jt
from repro.serving import scheduler as jsched
from repro.serving import serve_step as jss
from repro.training import checkpoint as jckpt
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core.plane import PlaneLayout as TLayout
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import serve_step as tss
from repro_torch.training import checkpoint as tckpt

torch.set_num_threads(2)

# tests/test_serving.py's MLA config without its experts
FIELDS = dict(name="mla", family="moe", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab_size=64, use_mla=True,
              kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16, n_experts=0, dtype="float32",
              param_dtype="float32")
JCFG, TCFG = JConfig(**FIELDS), TConfig(**FIELDS)

_PARAMS = {}


def _params(seed=0):
    """JAX init (jitted) and the same weights in the port."""
    if seed not in _PARAMS:
        jp = jax.jit(lambda k: jt.init_params(k, JCFG))(jax.random.key(seed))
        _PARAMS[seed] = jp, params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")
    return _PARAMS[seed]


def _fleet(seeds):
    jps, tps = zip(*(_params(s) for s in seeds))
    return (jax.tree.map(lambda *xs: jnp.stack(xs), *jps),
            tree_util.tree_map(lambda *xs: torch.stack(xs), *tps))


# ----------------------------------------------------------------------
# the fleet steps
# ----------------------------------------------------------------------
def test_fleet_steps_match_reference():
    """From a fresh cache, two nodes with their own params: one chunked
    prefill call (C = 5 per slot, lanes of 5, 3 and 0 tokens) and then 3
    plane-fed decode steps against the JAX ones: logits within 1e-5
    (measured at most 1.7e-6 at |logit| up to 3.1), the sampled tokens
    and positions exactly, the latent caches within 1e-5 (measured
    1.2e-6)."""
    jstack, tstack = _fleet((0, 3))
    jl, tl = JLayout.from_tree(jstack), TLayout.from_tree(tstack)
    assert jl.n_params == tl.n_params
    jplane, tplane = jl.pack(jstack), tl.pack(tstack)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, size=(2, 3, 5)).astype(np.int32)
    lens = np.array([[5, 3, 0], [5, 5, 3]], np.int32)
    jcache = jss.make_cache(JCFG, 2, 3, 16)
    tcache = tss.make_cache(TCFG, 2, 3, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: v.shape for k, v in jcache.items()}
    jlast, jsamp, jcache = jax.jit(jss.make_fleet_prefill_step(JCFG, jl))(
        jplane, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(lens),
        jcache)
    tlast, tsamp, tcache = tss.make_fleet_prefill_step(TCFG, tl)(
        tplane, torch.as_tensor(toks), torch.as_tensor(lens),
        torch.as_tensor(lens), tcache)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tsamp.numpy(), np.asarray(jsamp))
    jstep = jax.jit(jss.make_fleet_decode_step(JCFG, jl))
    tstep = tss.make_fleet_decode_step(TCFG, tl)
    for t in rng.integers(0, 64, size=(3, 2, 3, 1)).astype(np.int32):
        jlog, jcache = jstep(jplane, jnp.asarray(t), jcache)
        tlog, tcache = tstep(tplane, torch.as_tensor(t), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(tcache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
def test_forward_prefill_matches_reference(impl):
    """``make_forward_prefill`` for a fleet of two nodes (the kernel
    branch takes the plain version on the CPU, the JAX side its Pallas
    kernel in interpret mode): last-position logits within 1e-5
    (measured 1.7e-6 einsum, 1.3e-6 chunked, 1.9e-6 kernel branch, at
    |logit| up to 3.4), and equal to the full
    logits' last position."""
    jstack, tstack = _fleet((0, 3))
    toks = np.random.default_rng(6).integers(0, 64, size=(2, 3, 16)).astype(
        np.int32)
    jopts = jt.ForwardOptions(attn_impl=impl)
    topts = tt.ForwardOptions(attn_impl=impl)
    ref = jax.jit(jss.make_forward_prefill(JCFG, jopts))(
        jstack, {"tokens": jnp.asarray(toks)})
    last = tss.make_forward_prefill(TCFG, topts)(
        tstack, {"tokens": torch.as_tensor(toks)})
    full = tss.make_forward_prefill(TCFG, topts, last_only=False)(
        tstack, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert torch.equal(last, full[:, :, -1])


# ----------------------------------------------------------------------
# the schedulers
# ----------------------------------------------------------------------
def _workload(seed, n, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(1, 14))).tolist(),
             int(rng.integers(1, 9))) for _ in range(n)]


def _serve(mod, stacked, n, n_slots, work, **kw):
    cfg = JCFG if mod is jsched else TCFG
    fleet = mod.FleetScheduler(cfg, stacked, n_nodes=n, n_slots=n_slots,
                               max_seq=32, **kw)
    reqs = [mod.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for i, r in enumerate(reqs):
        fleet.submit(r, node=i % n)
    steps = fleet.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], steps


def test_fleet_scheduler_matches_reference():
    """Two nodes, two slots each, five requests per node, so slots are
    re-used: the reference resets only ``position`` on admission, which
    is enough for a latent cache (the mask hides old entries), so the
    port's FleetScheduler emits the JAX one's tokens for every request,
    in as many fleet steps; the loop mode agrees."""
    jstack, tstack = _fleet((0, 3))
    work = _workload(5, 10)
    want, jsteps = _serve(jsched, jstack, 2, 2, work)
    got, steps = _serve(tsched, tstack, 2, 2, work)
    assert got == want and steps == jsteps
    loop, _ = _serve(tsched, tstack, 2, 2, work, vmapped=False)
    assert loop == got


@pytest.mark.parametrize("chunk", [4, None], ids=["chunked", "replay"])
def test_node_scheduler_matches_reference(chunk):
    """One node, two slots, six requests: the port's NodeScheduler (the
    chunked prefill and the token-by-token replay) emits the JAX one's
    tokens."""
    jp, tp = _params(0)
    work = _workload(7, 6)
    out = {}
    for mod, cfg, p in ((jsched, JCFG, jp), (tsched, TCFG, tp)):
        sched = mod.NodeScheduler(cfg, p, n_slots=2, max_seq=32,
                                  prefill_chunk=chunk)
        reqs = [mod.Request(rid=i, prompt=pr, max_new=m)
                for i, (pr, m) in enumerate(work)]
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
        out[mod] = [r.output for r in reqs]
    assert out[tsched] == out[jsched]


def test_reused_slot_equals_greedy_generate():
    """One slot serves four requests in turn: each gets exactly what the
    port's ``greedy_generate`` gives its prompt from a fresh cache, though
    the latent cache still holds the previous request's entries past
    ``position``."""
    _, tp = _params(0)
    work = _workload(9, 4)
    sched = tsched.NodeScheduler(TCFG, tp, n_slots=1, max_seq=32,
                                 prefill_chunk=4)
    reqs = [tsched.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    assert float(sched.cache["ckv"].abs().max()) > 0
    for r in reqs:
        out = tss.greedy_generate(TCFG, tp, torch.tensor([r.prompt]),
                                  r.max_new, max_seq=32)
        assert r.output == out[0, len(r.prompt):].tolist(), r.rid


def test_admission_leaves_the_latent_cache_alone():
    """``reset_slots`` zeroes ``position`` of the fresh slots and passes
    the ``ckv``/``kr`` leaves through untouched."""
    cache = tss.make_cache(TCFG, 2, 3, 8, device="cpu")
    cache = {k: v + 7 for k, v in cache.items()}
    fresh = torch.tensor([[True, False, False], [False, False, True]])
    out = tss.reset_slots(cache, fresh)
    assert out["position"].tolist() == [[0, 7, 7], [7, 7, 0]]
    assert out["ckv"] is cache["ckv"] and out["kr"] is cache["kr"]


# ----------------------------------------------------------------------
# the MLA tree: interop, checkpoints, the CLI
# ----------------------------------------------------------------------
def test_params_from_jax_and_checkpoint_round_trip(tmp_path):
    """The bf16 MLA tree carries across from the JAX package
    (``params_from_jax``) and back (``params_to_numpy``) value for value,
    round-trips bit for bit through the port's checkpoint, and a file the
    JAX package wrote loads into the port's tree."""
    jc = dataclasses.replace(JCFG, dtype="bfloat16", param_dtype="bfloat16")
    tc = dataclasses.replace(TCFG, dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(2))
    like = tt.init_params(torch.Generator().manual_seed(0), tc)
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), "cpu", like=like)
    assert "w_uk" in tp["dense_layers"]["attn"]
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 3, tp)
    got, _, meta = tckpt.load_checkpoint(
        path, tree_util.tree_map(torch.zeros_like, tp))
    assert meta["step"] == 3
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(tp)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jp)
    got, _, _ = tckpt.load_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path / "jax")),
        tree_util.tree_map(torch.zeros_like, tp))
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(got),
                                                 tree_util.leaves(tp)))


def test_serve_cli_refuses_deepseek_until_the_moe_block_is_ported():
    """The MoE block is ported: the serve CLI serves deepseek-v2's smoke
    config (a dense MLA layer, then a MoE layer) on the CPU, every
    request to its length, and ``--loop`` (a scheduler per node) gives
    the fleet step's tokens."""
    args = ["--arch", "deepseek-v2-236b", "--smoke", "--nodes", "2",
            "--batch", "2", "--prompt-len", "6", "--new-tokens", "5",
            "--device", "cpu"]
    fleet = tserve.main(args)
    assert all(r.done and len(r.output) == 5 for r in fleet)
    assert [r.output for r in tserve.main(args + ["--loop"])] == [
        r.output for r in fleet]
