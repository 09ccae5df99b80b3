"""Port parity for serving the RWKV-6 family: the fleet's prefill and
decode steps and its schedulers against the JAX package's on the same
parameters and requests, the admission reset of the recurrent state (a
re-used slot serves exactly as a fresh decode does; the reference carries
the previous request's state over, which a test records), checkpoints of
the mixed-dtype tree and the serve CLI."""
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
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import serve_step as tss
from repro_torch.training import checkpoint as tckpt

torch.set_num_threads(2)

# the SSM config of tests/test_serving.py
FIELDS = dict(name="ssm", family="ssm", n_layers=2, d_model=64, d_ff=128,
              vocab_size=64, rwkv_head_dim=32, norm_kind="layernorm",
              dtype="float32", param_dtype="float32")
JCFG, TCFG = JConfig(**FIELDS), TConfig(**FIELDS)

_PARAMS = {}


def _params(seed=0):
    """JAX init (jitted) and the same weights in the port."""
    if seed not in _PARAMS:
        jp = jax.jit(lambda k: jt.init_params(k, JCFG))(jax.random.key(seed))
        like = tt.init_params(torch.Generator().manual_seed(0), TCFG)
        _PARAMS[seed] = jp, params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu",
            like=like)
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
    plane-fed decode steps against the JAX ones: logits within 1e-4
    (measured at most 9.0e-6 at |logit| up to 3.4), the sampled tokens
    and positions exactly, the state leaves within 1e-3 (measured 3.2e-4
    for the RWKV state, whose entries reach 174; 8.9e-6 for the
    carries)."""
    jstack, tstack = _fleet((0, 3))
    jl, tl = JLayout.from_tree(jstack), TLayout.from_tree(tstack)
    assert jl.n_params == tl.n_params
    jplane, tplane = jl.pack(jstack), tl.pack(tstack)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, size=(2, 3, 5)).astype(np.int32)
    lens = np.array([[5, 3, 0], [5, 5, 3]], np.int32)
    jcache = jss.make_cache(JCFG, 2, 3, 16)
    tcache = tss.make_cache(TCFG, 2, 3, 16, device="cpu")
    jlast, jsamp, jcache = jax.jit(jss.make_fleet_prefill_step(JCFG, jl))(
        jplane, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(lens),
        jcache)
    tlast, tsamp, tcache = tss.make_fleet_prefill_step(TCFG, tl)(
        tplane, torch.as_tensor(toks), torch.as_tensor(lens),
        torch.as_tensor(lens), tcache)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tsamp.numpy(), np.asarray(jsamp))
    jstep = jax.jit(jss.make_fleet_decode_step(JCFG, jl))
    tstep = tss.make_fleet_decode_step(TCFG, tl)
    for t in rng.integers(0, 64, size=(3, 2, 3, 1)).astype(np.int32):
        jlog, jcache = jstep(jplane, jnp.asarray(t), jcache)
        tlog, tcache = tstep(tplane, torch.as_tensor(t), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
    np.testing.assert_array_equal(tcache["position"].numpy(),
                                  np.asarray(jcache["position"]))
    for k in tt.SSM_STATE_LEAVES:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_prefill_matches_reference(use_kernel):
    """``make_forward_prefill`` for a fleet of two nodes (the scan kernel's
    plain version on the CPU, the Pallas kernel in interpret mode on the
    JAX side): last-position logits within 1e-4 (measured at most
    8.6e-6 at |logit| up to 2.6), and equal to the full logits' last
    position."""
    jstack, tstack = _fleet((0, 3))
    toks = np.random.default_rng(6).integers(0, 64, size=(2, 3, 10)).astype(
        np.int32)
    jopts = jt.ForwardOptions(use_ssm_kernel=use_kernel)
    topts = tt.ForwardOptions(use_ssm_kernel=use_kernel)
    ref = jax.jit(jss.make_forward_prefill(JCFG, jopts))(
        jstack, {"tokens": jnp.asarray(toks)})
    last = tss.make_forward_prefill(TCFG, topts)(
        tstack, {"tokens": torch.as_tensor(toks)})
    full = tss.make_forward_prefill(TCFG, topts, last_only=False)(
        tstack, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert torch.equal(last, full[:, :, -1])


# ----------------------------------------------------------------------
# the schedulers
# ----------------------------------------------------------------------
def _workload(seed, n, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(1, 14))).tolist(),
             int(rng.integers(1, 9))) for _ in range(n)]


def _serve(mod, cfg, stacked, n, n_slots, work, max_seq=32, **kw):
    fleet = mod.FleetScheduler(cfg, stacked, n_nodes=n, n_slots=n_slots,
                               max_seq=max_seq, **kw)
    reqs = [mod.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for i, r in enumerate(reqs):
        fleet.submit(r, node=i % n)
    steps = fleet.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], steps


def test_fleet_scheduler_matches_reference_on_first_admissions():
    """Every request takes a slot no request held before (3 per node, 3
    slots): where both packages agree on admission, the port's
    FleetScheduler emits the JAX one's tokens, in as many fleet steps."""
    jstack, tstack = _fleet((0, 3))
    work = _workload(5, 6)
    want, jsteps = _serve(jsched, JCFG, jstack, 2, 3, work)
    got, steps = _serve(tsched, TCFG, tstack, 2, 3, work)
    assert got == want and steps == jsteps


def _greedy(tp, prompt, n_new):
    out = tss.greedy_generate(TCFG, tp, torch.tensor([prompt]), n_new,
                              max_seq=32)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("chunk", [4, None], ids=["chunked", "replay"])
def test_node_scheduler_reused_slot_equals_fresh_decode(chunk):
    """One slot serves four requests in turn (chunked prefill and the
    token-by-token replay): each gets exactly what ``greedy_generate``
    gives its prompt from a fresh cache."""
    _, tp = _params(0)
    work = _workload(9, 4)
    sched = tsched.NodeScheduler(TCFG, tp, n_slots=1, max_seq=32,
                                 prefill_chunk=chunk)
    reqs = [tsched.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    for r in reqs:
        assert r.output == _greedy(tp, r.prompt, r.max_new), r.rid


def test_fleet_scheduler_reused_slots_equal_fresh_decode():
    """Two nodes with their own params, two slots each, five requests per
    node: every re-used slot serves exactly what ``greedy_generate`` gives
    the request's prompt on its node; the loop mode agrees."""
    jstack, tstack = _fleet((0, 3))
    work = _workload(11, 10)
    got, _ = _serve(tsched, TCFG, tstack, 2, 2, work)
    for i, ((prompt, m), out) in enumerate(zip(work, got)):
        assert out == _greedy(_params((0, 3)[i % 2])[1], prompt, m), i
    loop, _ = _serve(tsched, TCFG, tstack, 2, 2, work, vmapped=False)
    assert loop == got


# the case of ROADMAP Queue 3: init key 0, two 6-token prompts, one slot
STALE_PROMPTS = np.random.default_rng(0).integers(0, 64, size=(2, 6)).tolist()
FRESH = [[57, 4, 33, 55, 54], [33, 29, 33, 26, 19]]
REFERENCE_STALE = [59, 48, 53, 5, 57]


def _one_slot(mod, cfg, params):
    sched = mod.NodeScheduler(cfg, params, n_slots=1, max_seq=16,
                              prefill_chunk=4)
    reqs = [mod.Request(rid=i, prompt=p, max_new=5)
            for i, p in enumerate(STALE_PROMPTS)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    return [r.output for r in reqs]


def test_reference_carries_stale_state_into_a_reused_slot():
    """The divergence, stated: the JAX NodeScheduler resets only
    ``position`` on admission, so its second request starts from the
    first one's RWKV state and token-shift carries and gives
    [59, 48, 53, 5, 57], where a fresh decode of its prompt gives
    [33, 29, 33, 26, 19].  The port's scheduler zeroes those leaves and
    serves both requests as fresh decodes do."""
    jp, tp = _params(0)
    from repro.serving.serve_step import greedy_generate as jgreedy

    fresh = [np.asarray(jgreedy(JCFG, jp, jnp.asarray([p], jnp.int32), 5))
             [0, 6:].tolist() for p in STALE_PROMPTS]
    assert fresh == FRESH
    assert _one_slot(jsched, JCFG, jp) == [FRESH[0], REFERENCE_STALE]
    assert _one_slot(tsched, TCFG, tp) == FRESH
    assert [_greedy(tp, p, 5) for p in STALE_PROMPTS] == FRESH


def test_admission_zeroes_only_the_state_leaves():
    """``reset_slots`` zeroes position and the state leaves of the fresh
    slots only; the dense family's K/V leaves are left alone."""
    cache = {"position": torch.full((2, 3), 7, dtype=torch.int32),
             "rwkv_state": torch.ones((2, 2, 3, 4, 5, 5)),
             "tm_prev": torch.ones((2, 2, 3, 8)),
             "k": torch.ones((2, 2, 3, 6, 1, 4))}
    fresh = torch.tensor([[True, False, False], [False, False, True]])
    out = tss.reset_slots(cache, fresh)
    assert out["position"].tolist() == [[0, 7, 7], [7, 7, 0]]
    for k in ("rwkv_state", "tm_prev"):
        assert float(out[k][0, :, 0].abs().max()) == 0.0
        assert float(out[k][1, :, 2].abs().max()) == 0.0
        assert bool((out[k][0, :, 1:] == 1).all())
        assert bool((out[k][1, :, :2] == 1).all())
    assert out["k"] is cache["k"]


# ----------------------------------------------------------------------
# checkpoints and the CLI
# ----------------------------------------------------------------------
def test_checkpoint_round_trips_the_mixed_dtype_tree(tmp_path):
    """The bf16 RWKV tree with its two f32 leaves kinds: the port's file
    round-trips it bit for bit, each leaf in its own dtype, and a file the
    JAX package wrote of its own bf16 init loads into the port's tree."""
    bf = TConfig(**dict(FIELDS, dtype="bfloat16", param_dtype="bfloat16"))
    tp = tt.init_params(torch.Generator().manual_seed(1), bf)
    dtypes = {str(t.dtype) for t in tree_util.leaves(tp)}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 3, tp)
    got, _, meta = tckpt.load_checkpoint(
        path, tree_util.tree_map(torch.zeros_like, tp))
    assert meta["step"] == 3
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jc = JConfig(**dict(FIELDS, dtype="bfloat16", param_dtype="bfloat16"))
    jp = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.key(2))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jp)
    got, _, _ = tckpt.load_checkpoint(
        tckpt.latest_checkpoint(str(tmp_path / "jax")),
        tree_util.tree_map(torch.zeros_like, tp))
    for a, b in zip(tree_util.leaves(got), jax.tree.leaves(jp)):
        assert str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_serve_cli_rwkv_smoke_on_cpu(capsys):
    """``--arch rwkv6-3b --smoke --device cpu`` serves every request, and
    ``--loop`` (the per-node loop) gives the same tokens."""
    args = ["--arch", "rwkv6-3b", "--smoke", "--nodes", "2", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "5", "--device", "cpu"]
    fleet = tserve.main(args)
    loop = tserve.main(args + ["--loop"])
    assert len(fleet) == 4
    assert all(r.done and len(r.output) == 5 for r in fleet)
    assert [r.output for r in fleet] == [r.output for r in loop]
    out = capsys.readouterr().out
    assert "fleet plane" in out and "per-node loop" in out
