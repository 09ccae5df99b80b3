"""Port parity for the modality-frontend configs (internvl2-1b's vision
and musicgen-medium's audio stub): ``frontend_proj`` in the tree, the
forward pass from precomputed embeddings, ``lm_loss_fn`` on an
embeddings batch and one ``make_train_step`` step, against the JAX
package on parameters carried over from a JAX init and the same numpy
embeddings; and the serve CLI, which serves these configs on tokens as
the reference's does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.registry import get_config as jfull
from repro.configs.registry import get_smoke_config as jget
from repro.models import transformer as jt
from repro.training import losses as jlosses
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import tree as tree_util
from repro_torch.configs.base import ParallelConfig as TParallel
from repro_torch.configs.registry import get_smoke_config as tget
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.training import losses as tlosses
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

torch.set_num_threads(2)

ARCHS = ("internvl2-1b", "musicgen-medium")
# per node, the reference's trees at full size (jax.eval_shape)
FULL_PARAMS = {"internvl2-1b": 630_553_728, "musicgen-medium": 1_365_740_544}


def _configs(arch, dtype="float32"):
    jc, tc = jget(arch), tget(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return (dataclasses.replace(jc, dtype=dtype, param_dtype=dtype),
            dataclasses.replace(tc, dtype=dtype, param_dtype=dtype))


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


def _embeddings(cfg, shape, seed=1):
    """Seeded stub frontend outputs ``shape + (frontend_dim,)``, f32."""
    return np.random.default_rng(seed).standard_normal(
        tuple(shape) + (cfg.frontend_dim,)).astype(np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_the_reference(arch):
    """The smoke tree (``frontend_proj`` ``(frontend_dim, d_model)``
    beside the token embedding and the head) has the reference's leaves,
    shapes and dtypes, and the full config its parameter count (630,553,728
    for internvl2-1b, 1,365,740,544 for musicgen-medium; ``jax.eval_shape``,
    no draw)."""
    jc, tc = _configs(arch)
    jp, _ = _params(jc, tc)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc)
    assert tp["frontend_proj"].shape == (tc.frontend_dim, tc.d_model)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jfull(arch)),
                            jax.random.key(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == FULL_PARAMS[arch]


@pytest.mark.parametrize("impl", tt.ATTN_IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_from_embeddings_matches_reference(arch, impl):
    """``forward`` on ``{"embeddings": (2, 24, F)}`` (no √d scale, the
    frontend projection instead of the token rows): f32 logits within
    1e-5 of the reference's for every attention implementation (measured
    at most 2.9e-6 at |logits| ≤ 4.3); a batch holding both inputs is
    read from its embeddings, as in the reference."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    emb = _embeddings(jc, (2, 24))
    ref = np.asarray(jax.jit(lambda p, e: jt.forward(
        p, jc, {"embeddings": e}, jt.ForwardOptions(attn_impl=impl,
                                                    remat=False))[0])(
        jp, jnp.asarray(emb)))
    out, aux = tt.forward(tp, tc, {"embeddings": torch.as_tensor(emb)},
                          tt.ForwardOptions(attn_impl=impl))
    assert out.shape == ref.shape and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    both = {"embeddings": torch.as_tensor(emb),
            "tokens": torch.zeros((2, 24), dtype=torch.int32)}
    assert torch.equal(tt.forward(tp, tc, both,
                                  tt.ForwardOptions(attn_impl=impl))[0], out)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_from_embeddings_matches_reference_bf16(arch):
    """The bf16 configs (the dtype the card runs) from f32 embeddings:
    logits are bf16 values cast to f32 on both sides, within four bf16
    ulps of the largest logit (measured at most 1.5 ulps)."""
    jc, tc = _configs(arch, "bfloat16")
    jp, tp = _params(jc, tc)
    emb = _embeddings(jc, (2, 24), seed=2)
    ref = np.asarray(jax.jit(lambda p, e: jt.forward(
        p, jc, {"embeddings": e}, jt.ForwardOptions(remat=False))[0])(
        jp, jnp.asarray(emb)))
    out = tt.forward(tp, tc, {"embeddings": torch.as_tensor(emb)})[0]
    assert np.abs(out.numpy() - ref).max() <= 4 * _bf16_ulp(
        np.abs(ref).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_forward_from_embeddings_equals_its_nodes(arch):
    """``forward_nodes`` on ``(N, B, S, F)`` embeddings of two nodes with
    their own params equals each node's ``forward`` bit for bit."""
    jc, tc = _configs(arch)
    tps = [_params(jc, tc, s)[1] for s in (0, 1)]
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *tps)
    emb = torch.as_tensor(_embeddings(jc, (2, 2, 16), seed=3))
    fleet, _ = tt.forward_nodes(stacked, tc, emb)
    for i, tp in enumerate(tps):
        assert torch.equal(fleet[i], tt.forward(tp, tc,
                                                {"embeddings": emb[i]})[0])


@pytest.mark.parametrize("chunked_ce", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_fn_with_embeddings_matches_reference(arch, chunked_ce):
    """``lm_loss_fn`` on ``{"embeddings", "labels"}``, whole and chunked
    cross-entropy: the loss within 1e-5 (measured at most 4.8e-7 at
    6.3) and its gradient in every leaf, ``frontend_proj`` included,
    within 1e-6 (measured at most 1.0e-7)."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    emb = _embeddings(jc, (2, 16), seed=4)
    labels = np.random.default_rng(5).integers(0, jc.vocab_size,
                                               (2, 16)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jlosses.lm_loss_fn(
        jc, jt.ForwardOptions(remat=False), chunked_ce=chunked_ce)))(
        jp, {"embeddings": jnp.asarray(emb), "labels": jnp.asarray(labels)})
    tp = tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tlosses.lm_loss_fn(tc, chunked_ce=chunked_ce)(
        tp, {"embeddings": torch.as_tensor(emb),
             "labels": torch.as_tensor(labels)})
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= 1e-5, (loss, float(jl))
    for (path, t), g in zip(tree_util.leaves_with_paths(tp),
                            jax.tree.leaves(jg)):
        # the token embedding is not read: no gradient, the reference's 0
        grad = torch.zeros_like(t) if t.grad is None else t.grad
        err = float(np.abs(grad.numpy() - np.asarray(g)).max())
        assert err <= 1e-6, (path, err)
    assert tp["embed"].grad is None
    assert float(tp["frontend_proj"].grad.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_with_embeddings_matches_reference(arch):
    """One ``make_train_step`` step (SGD 0.1, gossip through a 2 × 2
    mixing matrix) on the f32 smoke config at n = 2 nodes (distinct
    inits), 2 microbatches of 2 × 12 embeddings a node, the 4-D
    ``embeddings`` leaf reshaped by ``reshape_for_microbatch`` beside
    ``labels``: the loss within 1e-5 and every param within 2e-7
    (measured at most 1.2e-7, a norm scale); ``frontend_proj`` moves and the token
    embedding, which an embeddings batch does not read, does not."""
    jc, tc = _configs(arch)
    n, micro = 2, 2
    jps, tps = zip(*(_params(jc, tc, s) for s in range(n)))
    jpar = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    tpar = tree_util.tree_map(lambda *xs: torch.stack(xs), *tps)
    jpc, tpc = (JParallel(n_nodes=n, microbatch=micro),
                TParallel(n_nodes=n, microbatch=micro))
    jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    jstep = jax.jit(jts.make_train_step(jc, jpc, jo))
    tstep = tts.make_train_step(tc, tpc, to)
    batch = {"embeddings": _embeddings(jc, (n * micro * 2, 12), seed=6),
             "labels": np.random.default_rng(7).integers(
                 0, jc.vocab_size, (n * micro * 2, 12)).astype(np.int32)}
    jb = jts.reshape_for_microbatch(jax.tree.map(jnp.asarray, batch), n,
                                    micro)
    tb = tts.reshape_for_microbatch(
        tree_util.tree_map(torch.as_tensor, batch), n, micro)
    assert tb["embeddings"].shape == (n, micro, 2, 12, jc.frontend_dim)
    coeffs = np.array([[0.75, 0.25], [0.5, 0.5]], np.float32)
    jnew, _, jl = jstep(jpar, jax.vmap(jo.init)(jpar), jb,
                        jnp.asarray(coeffs))
    tnew, _, tl = tstep(tpar, to.init(tpar), tb, torch.as_tensor(coeffs))
    assert abs(float(tl) - float(jl)) <= 1e-5, (float(tl), float(jl))
    for (path, a), b in zip(tree_util.leaves_with_paths(tnew),
                            jax.tree.leaves(jnew)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= 2e-7, (path, err)
    mixed = tree_util.tree_map(
        lambda p: torch.einsum("ij,j...->i...", torch.as_tensor(coeffs), p),
        tpar)
    assert torch.equal(tnew["embed"], mixed["embed"])
    assert not torch.equal(tnew["frontend_proj"], mixed["frontend_proj"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_frontend_smoke_on_cpu(arch, capsys):
    """The serve CLI on a frontend config serves token prompts through
    the decode path, as the reference's CLI does; ``--loop`` agrees."""
    args = ["--arch", arch, "--smoke", "--nodes", "2", "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "4", "--device", "cpu"]
    fleet = tserve.main(args)
    loop = tserve.main(args + ["--loop"])
    assert all(r.done and len(r.output) == 4 for r in fleet)
    assert [r.output for r in fleet] == [r.output for r in loop]
    assert "fleet plane" in capsys.readouterr().out


def test_train_step_gossips_through_the_fused_plane_as_the_reference():
    """``make_train_step`` gossips over the packed plane (the fused-plane
    kernel's plain version on the CPU): two steps of internvl2-1b's bf16
    smoke config at n = 4, microbatch 1, AdamW, BA(4, 2)'s degree matrix
    leave every param within one bf16 ulp of the same steps without
    gossip followed by the reference's leaf-by-leaf ``mix_dense``
    (measured: equal), with the same losses."""
    from repro_torch.core.decentralized import round_coeffs
    from repro_torch.core.mixing import mix_dense
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert

    _, tc = _configs("internvl2-1b", "bfloat16")
    n = 4
    tpar = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[tt.init_params(torch.Generator().manual_seed(s), tc)
          for s in range(n)])
    coeffs = torch.as_tensor(round_coeffs(
        barabasi_albert(n, 2, 0), AggregationStrategy("degree"), 0))
    pcfg = TParallel(n_nodes=n, microbatch=1)
    rng = np.random.default_rng(8)
    batches = [tts.reshape_for_microbatch({
        "embeddings": torch.as_tensor(_embeddings(tc, (2 * n, 16),
                                                  seed=9 + i)),
        "labels": torch.as_tensor(rng.integers(0, tc.vocab_size,
                                               (2 * n, 16)))}, n, 1)
        for i in range(2)]
    out = {}
    for gossip in (True, False):
        opt = topt.adamw(1e-3)
        step = tts.make_train_step(tc, pcfg, opt, gossip=gossip)
        params, state, losses = tpar, opt.init(tpar), []
        for b in batches:
            params, state, loss = step(params, state, b, coeffs)
            if not gossip:
                params = mix_dense(params, coeffs)
            losses.append(float(loss))
        out[gossip] = params, losses
    assert out[True][1] == out[False][1]
    for (path, a), b in zip(tree_util.leaves_with_paths(out[True][0]),
                            tree_util.leaves(out[False][0])):
        assert a.dtype == b.dtype == torch.bfloat16, path
        err = (a.float() - b.float()).abs().numpy()
        assert (err <= _bf16_ulp(b.float().abs().numpy())).all(), path
