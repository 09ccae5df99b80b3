"""Port parity for the serving tier: the chunked self-feeding prefill,
the schedulers, plane swaps, checkpoints and the serve CLI, held against
the JAX package's on the same parameters (``params_from_jax``) and the
same requests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.registry import get_smoke_config as jget
from repro.models import transformer as jt
from repro.serving import scheduler as jsched
from repro.training import checkpoint as jckpt
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.core import prng
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import serve_step as tss
from repro_torch.training import checkpoint as tckpt

torch.set_num_threads(2)

FIELDS = dict(name="sched", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab_size=64, dtype="float32", param_dtype="float32")
JCFG, TCFG = JConfig(**FIELDS), TConfig(**FIELDS)


def _jax_params(cfg, seed=0):
    return jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(seed))


def _port(jp, dtype=None):
    return params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), "cpu", dtype)


@pytest.fixture(scope="module")
def params():
    jp = _jax_params(JCFG)
    return jp, _port(jp)


def _stack(tree, n):
    return tree_util.tree_map(
        lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.ndim), tree)


def _workload(seed=0, n=8, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(1, 18))).tolist(),
             int(rng.integers(1, 12))) for _ in range(n)]


# ----------------------------------------------------------------------
# the chunked prefill step
# ----------------------------------------------------------------------
def test_chunked_prefill_equals_decode_loop_bit_for_bit(params):
    """One chunk of C = 6 tokens for every slot is C decode steps, bit for
    bit: the last logits, every cache leaf and the position."""
    _, tp = params
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 64, size=(3, 6)).astype(np.int32))
    cache0 = tt.init_cache(TCFG, 3, 16, device="cpu")
    full = torch.full((3,), 6, dtype=torch.int32)
    last, sampled, cache = tss.make_prefill_step(TCFG)(tp, toks, full, full,
                                                       cache0)
    ref_cache = cache0
    for i in range(6):
        logits, ref_cache = tt.decode_step(tp, TCFG, toks[:, i:i + 1],
                                           ref_cache)
        assert torch.equal(sampled[:, i], torch.argmax(logits[:, 0], -1)
                           .to(torch.int32))
    assert torch.equal(last, logits[:, 0])
    for k in ref_cache:
        assert torch.equal(cache[k], ref_cache[k]), k


def test_frozen_slots_are_bit_exact(params):
    """Slots with ``lens = 0`` keep every cache leaf, position included,
    bit for bit, and their last-logits row is zero."""
    _, tp = params
    rng = np.random.default_rng(1)
    cache = tt.init_cache(TCFG, 3, 16, device="cpu")
    warm = torch.as_tensor(rng.integers(0, 64, size=(3, 4)).astype(np.int32))
    n4 = torch.full((3,), 4, dtype=torch.int32)
    _, _, cache = tss.make_prefill_step(TCFG)(tp, warm, n4, n4, cache)
    toks = torch.as_tensor(rng.integers(0, 64, size=(3, 5)).astype(np.int32))
    lens = torch.tensor([5, 0, 2], dtype=torch.int32)
    last, _, new = tss.make_prefill_step(TCFG)(tp, toks, lens, lens, cache)
    assert torch.equal(new["position"], torch.tensor([9, 4, 6],
                                                     dtype=torch.int32))
    for k in ("k", "v"):
        assert torch.equal(new[k][:, 1], cache[k][:, 1])
        assert not torch.equal(new[k][:, 0], cache[k][:, 0])
    assert torch.equal(last[1], torch.zeros(64))


def test_self_feed_matches_greedy(params):
    """A lane fed one planned token self-feeds its greedy samples: it
    generates what ``greedy_generate`` does after the same prompt."""
    _, tp = params
    prompt = torch.tensor([[3, 17, 42, 5]], dtype=torch.int32)
    want = tss.greedy_generate(TCFG, tp, prompt, 6, max_seq=16)[0, 4:]
    cache = tt.init_cache(TCFG, 1, 16, device="cpu")
    n3 = torch.tensor([3], dtype=torch.int32)
    _, _, cache = tss.make_prefill_step(TCFG)(tp, prompt[:, :3], n3, n3, cache)
    toks = torch.zeros((1, 6), dtype=torch.int32)
    toks[0, 0] = prompt[0, 3]
    _, sampled, _ = tss.make_prefill_step(TCFG)(
        tp, toks, torch.tensor([1], dtype=torch.int32),
        torch.tensor([6], dtype=torch.int32), cache)
    assert sampled[0].tolist() == want.tolist()


def test_greedy_generate_matches_reference(params):
    jp, tp = params
    from repro.serving.serve_step import greedy_generate as jgreedy

    prompt = np.array([[3, 17, 42, 5], [9, 1, 60, 2]], np.int32)
    want = np.asarray(jgreedy(JCFG, jp, jnp.asarray(prompt), 8))
    got = tss.greedy_generate(TCFG, tp, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # temperature sampling: the reference's jax.random stream, its tokens
    want = np.asarray(jgreedy(JCFG, jp, jnp.asarray(prompt), 8,
                              temperature=0.7, rng=jax.random.PRNGKey(3)))
    got = tss.greedy_generate(TCFG, tp, torch.as_tensor(prompt), 8,
                              temperature=0.7, rng=prng.key(3))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# schedulers
# ----------------------------------------------------------------------
def _serve(mod, cfg, stacked, n, work, **kw):
    fleet = mod.FleetScheduler(cfg, stacked, n_nodes=n, n_slots=2,
                               max_seq=48, **kw)
    reqs = [mod.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(work)]
    for i, r in enumerate(reqs):
        fleet.submit(r, node=i % n)
    steps = fleet.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], steps


@pytest.mark.parametrize("arch", [None, "gemma2-27b"])
def test_fleet_scheduler_matches_reference(arch):
    """The port's FleetScheduler emits token for token what the JAX
    FleetScheduler emits for the same requests on the same three node
    models (distinct inits), with the same number of fleet steps."""
    jc, tc = (JCFG, TCFG) if arch is None else (jget(arch), tget(arch))
    n = 3
    jps = [_jax_params(jc, s) for s in range(n)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    tstack = tree_util.tree_map(lambda *xs: torch.stack(xs),
                                *[_port(p) for p in jps])
    work = _workload(5, n=7, vocab=jc.vocab_size)
    want, jsteps = _serve(jsched, jc, jstack, n, work)
    got, steps = _serve(tsched, tc, tstack, n, work)
    assert got == want
    assert steps == jsteps


def test_loop_mode_equals_fleet_mode(params):
    """``vmapped=False`` (a Python loop of per-node schedulers) emits the
    fleet step's tokens, and the legacy token-by-token replay agrees."""
    _, tp = params
    stacked = _stack(tp, 2)
    work = _workload(3)
    fleet, _ = _serve(tsched, TCFG, stacked, 2, work)
    loop, _ = _serve(tsched, TCFG, stacked, 2, work, vmapped=False)
    replay, _ = _serve(tsched, TCFG, stacked, 2, work, vmapped=False,
                       prefill_chunk=None)
    assert fleet == loop == replay


def test_swap_node_writes_the_plane_row_in_place(params):
    """``swap_node`` overwrites one plane row in place (same storage, the
    views handed out before see the new weights) and the next request on
    that node decodes with them: its first token is the argmax of a
    full-sequence prefill (``make_forward_prefill``, flash attention's
    plain version on the CPU) with the swapped params."""
    jp, tp = params
    other = _port(_jax_params(JCFG, 7))
    fleet = tsched.FleetScheduler(TCFG, _stack(tp, 3), n_nodes=3, n_slots=2,
                                  max_seq=32)
    ptr, views = fleet.plane.data_ptr(), fleet.layout.unpack(fleet.plane)
    fleet.swap_node(1, other)
    assert fleet.plane.data_ptr() == ptr
    assert torch.equal(views["head"][1], other["head"])
    assert torch.equal(views["head"][0], tp["head"])
    prompts = [[5, 9, 11, 3, 60], [7, 7, 2]]
    reqs = [tsched.Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        fleet.submit(r, node=1)
    fleet.run_until_drained()
    prefill = tss.make_forward_prefill(TCFG, tt.ForwardOptions(
        attn_impl="pallas"))
    for r in reqs:
        logits = prefill(tt.add_node_axis(other),
                         {"tokens": torch.tensor([[r.prompt]])})
        assert r.output[0] == int(torch.argmax(logits[0, 0]))


def test_plane_rows_match_reference(params):
    """``pack_row``/``unpack_row`` round-trip one node, the row is the
    reference's row (the same column order), and ``plane_nbytes`` is the
    reference's."""
    from repro.core.plane import PlaneLayout as JLayout
    from repro_torch.core.plane import PlaneLayout as TLayout

    jp, tp = params
    jl = JLayout.from_tree(jax.tree.map(lambda a: a[None], jp))
    tl = TLayout.from_tree(tt.add_node_axis(tp))
    row = tl.pack_row(tp)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jl.pack_row(jp)))
    back = tl.unpack_row(row)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(back),
                                                 tree_util.leaves(tp)))
    for dtype, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        assert tl.plane_nbytes(dtype) == jl.plane_nbytes(jdt)
    with pytest.raises(ValueError, match="pack_row"):
        tl.pack_row(tt.add_node_axis(tp))


def test_pack_row_writes_a_plane_row_in_place(params):
    """``pack_row(out=)`` writes the same row as ``pack_row()`` into the
    given row of a plane, leaving the other rows; an ``out`` of another
    size or dtype raises instead of being filled."""
    from repro_torch.core.plane import PlaneLayout as TLayout

    _, tp = params
    tl = TLayout.from_tree(_stack(tp, 3))
    plane = tl.pack(_stack(tp, 3))
    other = tree_util.tree_map(lambda x: x + 1, tp)
    before = plane.clone()
    row = tl.pack_row(other, out=plane[1])
    assert row.data_ptr() == plane[1].data_ptr()
    assert torch.equal(plane[1], tl.pack_row(other))
    assert torch.equal(plane[0], before[0]) and torch.equal(plane[2],
                                                            before[2])
    with pytest.raises(ValueError, match="out must be"):
        tl.pack_row(other, dtype=torch.bfloat16, out=plane[1])
    with pytest.raises(ValueError, match="out must be"):
        tl.pack_row(other, out=plane[1, :-1])


def test_forward_prefill_last_only_matches_full_logits(params):
    _, tp = params
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, 64, size=(2, 3, 10)).astype(np.int32))
    stacked = _stack(tp, 2)
    for impl in ("einsum", "pallas"):
        opts = tt.ForwardOptions(attn_impl=impl)
        last = tss.make_forward_prefill(TCFG, opts)(stacked, {"tokens": toks})
        full = tss.make_forward_prefill(TCFG, opts, last_only=False)(
            stacked, {"tokens": toks})
        assert last.shape == (2, 3, 64) and full.shape == (2, 3, 10, 64)
        assert torch.equal(last, full[:, :, -1])


def test_fleet_steps_match_reference(params):
    """The plane-fed fleet decode step against the JAX one, 4 steps, two
    nodes with different params: logits within 1e-5 (measured 1.7e-6)."""
    from repro.core.plane import PlaneLayout as JLayout
    from repro.serving import serve_step as jss
    from repro_torch.core.plane import PlaneLayout as TLayout

    jps = [_jax_params(JCFG, s) for s in (0, 3)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    tstack = tree_util.tree_map(lambda *xs: torch.stack(xs),
                                *[_port(p) for p in jps])
    jl, tl = JLayout.from_tree(jstack), TLayout.from_tree(tstack)
    assert jl.n_params == tl.n_params
    jstep = jax.jit(jss.make_fleet_decode_step(JCFG, jl))
    tstep = tss.make_fleet_decode_step(TCFG, tl)
    jcache = jss.make_cache(JCFG, 2, 2, 8)
    tcache = tss.make_cache(TCFG, 2, 2, 8, device="cpu")
    jplane, tplane = jl.pack(jstack), tl.pack(tstack)
    toks = np.random.default_rng(4).integers(0, 64, size=(4, 2, 2, 1))
    for t in toks.astype(np.int32):
        jlog, jcache = jstep(jplane, jnp.asarray(t), jcache)
        tlog, tcache = tstep(tplane, torch.as_tensor(t), tcache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(tcache["position"].numpy(),
                                  np.asarray(jcache["position"]))


# ----------------------------------------------------------------------
# checkpoints and the CLI
# ----------------------------------------------------------------------
def test_jax_checkpoint_loads_in_the_port(params, tmp_path):
    jp, tp = params
    opt = {"mu": jax.tree.map(jnp.zeros_like, jp["final_norm"]),
           "step": jnp.asarray([3], jnp.int32)}
    jckpt.save_checkpoint(str(tmp_path), 12, jp, opt, {"round": 4})
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_00000012.npz")
    skeleton = tree_util.tree_map(torch.zeros_like, tp)
    opt_like = {"mu": tree_util.tree_map(torch.ones_like, tp["final_norm"]),
                "step": torch.zeros(1, dtype=torch.int32)}
    got, opt_got, meta = tckpt.load_checkpoint(path, skeleton, opt_like)
    assert meta == {"round": 4, "step": 12}
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(tp)):
        assert torch.equal(a, b)
    assert int(opt_got["step"][0]) == 3
    assert all(float(x.abs().max()) == 0.0
               for x in tree_util.leaves(opt_got["mu"]))


def test_checkpoint_round_trip_bf16_and_into_jax(params, tmp_path):
    """A bf16 tree round-trips bit for bit through the port's file, and an
    f32 one written by the port loads in the JAX package."""
    _, tp = params
    bf = tree_util.tree_map(lambda t: t.to(torch.bfloat16), tp)
    path = tckpt.save_checkpoint(str(tmp_path / "bf"), 1, bf)
    got, _, _ = tckpt.load_checkpoint(
        path, tree_util.tree_map(torch.zeros_like, bf))
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(got),
                                                 tree_util.leaves(bf)))
    jp = _jax_params(JCFG)
    path = tckpt.save_checkpoint(str(tmp_path / "f32"), 2, tp)
    back, _, meta = jckpt.load_checkpoint(path, jp)
    assert meta["step"] == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="dtype"):
        tckpt.load_checkpoint(path, tree_util.tree_map(
            lambda t: t.to(torch.float64), tp))


@pytest.mark.parametrize("loop", [False, True])
def test_serve_cli_smoke_on_cpu(loop, capsys):
    args = ["--arch", "stablelm-1.6b", "--smoke", "--nodes", "2", "--batch",
            "2", "--prompt-len", "8", "--new-tokens", "5", "--device", "cpu"]
    reqs = tserve.main(args + (["--loop"] if loop else []))
    assert len(reqs) == 4 and all(r.done and len(r.output) == 5 for r in reqs)
    assert "served 2 nodes" in capsys.readouterr().out


def test_serve_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "stablelm-1.6b", "--smoke"])


def test_configs_equal_the_reference():
    from repro.configs.registry import ARCHS as JARCHS
    from repro.configs.registry import get_config as jfull
    from repro_torch.configs.registry import ARCHS as TARCHS
    from repro_torch.configs.registry import get_config as tfull

    assert sorted(JARCHS) == sorted(TARCHS)
    for arch in JARCHS:
        for jf, tf in ((jfull, tfull), (jget, tget)):
            jc, tc = jf(arch), tf(arch)
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
            assert jc.param_count() == tc.param_count()
            assert str(tc.weight_dtype) == "torch." + str(jc.weight_dtype)
