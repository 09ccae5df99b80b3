"""Abstract inputs for the dry-run, without memory (port of
``repro/launch/specs.py``).

``input_specs(arch, shape, multi_pod)`` returns what ``dryrun.py`` needs to
run a step for one (architecture × input shape) pair: the stacked params,
optimizer state, batch and cache as **fake tensors** (shapes and dtypes
under one ``FakeTensorMode``, no storage: deepseek-v2 at full size is
236 B parameters a node), their partition specs (``repro_torch.sharding``)
and which step to run.  The reference builds ``ShapeDtypeStruct`` trees
with ``jax.eval_shape``; the port runs its own inits under the fake mode
instead (the truncated-normal draw, a data-dependent rejection step, is
skipped there: a fake tensor has no values to draw).

Shape → step (the reference's):
  train_4k               → train_step   (tokens + labels)
  prefill_32k            → prefill_step (last-position logits)
  decode_32k, long_500k  → serve_step   (ONE token vs a seq_len cache)

long_500k is applicable only to sub-quadratic archs (``applicable_shapes``
encodes the skip rule; skips are recorded, not silently dropped).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import InputShape, ModelConfig, ParallelConfig, SHAPES
from repro_torch.configs.registry import get_config, get_parallel
from repro_torch.sharding import PartitionSpec as P
from repro_torch.sharding import opt_specs_like, param_specs

__all__ = ["DryRunSpec", "input_specs", "applicable_shapes", "LONG_CTX_OK",
           "LONG_CTX_SKIP", "NODE_AXES"]

NODE_AXES = ("pod", "node")

# long_500k rule: SSM/hybrid always; dense only with a sliding-window
# variant; pure full-attention archs skip (the reference's table).
LONG_CTX_OK = {
    "rwkv6-3b": "ssm: O(1) state",
    "hymba-1.5b": "hybrid: SSM state + mostly-local attention",
    "gemma2-27b": "sliding-window variant on alternating layers",
    "starcoder2-7b": "sliding-window variant on alternating layers",
}
LONG_CTX_SKIP = {
    "musicgen-medium": "pure full attention (48L MHA) — no sub-quadratic variant",
    "stablelm-1.6b": "pure full attention — no sub-quadratic variant",
    "phi3-mini-3.8b": "pure full attention — no sub-quadratic variant",
    "internvl2-1b": "pure full attention — no sub-quadratic variant",
    "llama4-scout-17b-a16e": "full attention in this config — skip per rule",
    "deepseek-v2-236b": "full (latent) attention; MLA shrinks the cache but "
                        "attention stays O(L) per token / O(L²) prefill — skip per rule",
}


def applicable_shapes(arch: str):
    out = []
    for name, shape in SHAPES.items():
        if name == "long_500k" and arch not in LONG_CTX_OK:
            continue
        out.append(shape)
    return out


@dataclasses.dataclass
class DryRunSpec:
    arch: str
    shape: InputShape
    kind: str                      # train | prefill | decode
    n_global_nodes: int
    abstract_args: Tuple[Any, ...]     # fake tensors, step-ordered
    in_specs: Tuple[Any, ...]          # PartitionSpec trees, same order
    out_specs: Any
    meta: Dict[str, Any]
    fake_mode: Any = None              # the FakeTensorMode of the args


@contextlib.contextmanager
def _no_draws():
    """Inits under a fake mode: ``trunc_normal_`` leaves its tensor as it
    is (its rejection step reads values a fake tensor does not have)."""
    real = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *a, **k: t
    try:
        yield
    finally:
        torch.nn.init.trunc_normal_ = real


def _stacked(tree, n: int):
    """Fresh ``(n, ...)`` fakes for each leaf of one node's tree (inside
    the fake mode)."""
    return tree_util.tree_map(
        lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype), tree)


def _abstract_params(cfg: ModelConfig, n_nodes: int):
    """Stacked abstract params: the real init, a node axis prepended."""
    from repro_torch.models.transformer import init_params

    with _no_draws():
        one = init_params(torch.Generator(), cfg)
    return _stacked(one, n_nodes)


def _abstract_opt(stacked_params):
    from repro_torch.training.optimizer import make_optimizer

    return make_optimizer("adamw", 3e-4).init(stacked_params)


def _train_inputs(cfg: ModelConfig, pcfg: ParallelConfig, shape: InputShape,
                  n_global: int):
    gb, s = shape.global_batch, shape.seq_len
    local = max(1, gb // n_global)
    fsdp = pcfg.fsdp
    micro = max(1, min(pcfg.microbatch, local))
    # microbatch must divide the local batch AND leave each microbatch
    # divisible by the fsdp axis (batch shards over fsdp)
    while micro > 1 and (local % micro or (local // micro) % fsdp):
        micro -= 1
    mb = local // micro
    use_fsdp_batch = mb % fsdp == 0
    batch: Dict[str, Any] = {}
    if cfg.frontend is not None:
        batch["embeddings"] = torch.empty(
            (n_global, micro, mb, s, cfg.frontend_dim), dtype=torch.bfloat16)
    else:
        batch["tokens"] = torch.empty((n_global, micro, mb, s),
                                      dtype=torch.int32)
    batch["labels"] = torch.empty((n_global, micro, mb, s), dtype=torch.int32)

    nd = NODE_AXES
    b_axis = "fsdp" if use_fsdp_batch else None
    specs = {
        k: P(nd, None, b_axis, *([None] * (len(v.shape) - 3)))
        for k, v in batch.items()
    }
    return batch, specs, dict(micro=micro, local_batch=local)


def _decode_inputs(cfg: ModelConfig, shape: InputShape, n_global: int,
                   multi_pod: bool, tp: int = 16):
    """serve_step inputs: tokens (N, B, 1) + stacked cache."""
    from repro_torch.models.transformer import init_cache

    gb, s = shape.global_batch, shape.seq_len
    if shape.name == "long_500k":
        # single stream: node axis idles for batch; the CACHE sequence dim
        # shards over (pod, node, fsdp) instead (sequence-sharded decode).
        n_serve, local = 1, 1
        seq_axes = ("pod", "node", "fsdp") if multi_pod else ("node", "fsdp")
        batch_axis = None
    else:
        n_serve = n_global
        local = max(1, gb // n_global)
        seq_axes = None
        batch_axis = "fsdp"

    tokens = torch.empty((n_serve, local, 1), dtype=torch.int32)
    cache = _stacked(init_cache(cfg, local, s, device="cpu"), n_serve)

    def cspec(name, leaf):
        nd = NODE_AXES if n_serve > 1 else None
        if name == "position":
            return P(nd, batch_axis)
        ndim = leaf.ndim
        spec = [None] * ndim
        spec[0] = nd
        if ndim >= 3:
            spec[2] = batch_axis
        # sequence dim (index 3 for k/v/ckv/kr) → seq sharding for long ctx
        if name in ("k", "v", "ckv", "kr") and ndim >= 4 and seq_axes:
            spec[3] = seq_axes
        # head-ish dims over model where divisible
        dim_for_model = {"k": 4, "v": 4, "rwkv_state": 3, "ssm_state": 3,
                         "conv_state": 4}.get(name)
        if dim_for_model is not None and dim_for_model < ndim:
            if leaf.shape[dim_for_model] % tp == 0:
                spec[dim_for_model] = "model"
        return P(*spec)

    cache_spec = {k: cspec(k, v) for k, v in cache.items()}
    tok_spec = P(NODE_AXES if n_serve > 1 else None, batch_axis, None)
    return tokens, cache, tok_spec, cache_spec, dict(
        n_serve=n_serve, local_batch=local, seq_axes=seq_axes)


def input_specs(arch: str, shape_name: Union[str, InputShape], *,
                multi_pod: bool = False,
                cfg: Optional[ModelConfig] = None,
                pcfg: Optional[ParallelConfig] = None) -> DryRunSpec:
    """The reference's ``input_specs``; ``shape_name`` may also be an
    ``InputShape`` of the caller's (a card run's own batch and length).
    The trees are fakes of a new ``FakeTensorMode``, kept in
    ``DryRunSpec.fake_mode`` (real CPU scalars a step makes are taken in
    as fakes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    pcfg = pcfg or get_parallel(arch)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else SHAPES[shape_name])
    pods = 2 if multi_pod else 1
    n_global = pods * pcfg.n_nodes
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    axis_sizes = {"model": pcfg.tp_degree, "fsdp": pcfg.fsdp}
    spec = lambda **kw: DryRunSpec(arch=arch, shape=shape, fake_mode=mode,
                                   **kw)
    with mode:
        p_abs = _abstract_params(cfg, n_global)
        p_specs = param_specs(p_abs, node_axes=NODE_AXES,
                              axis_sizes=axis_sizes)

        if shape.kind == "train":
            opt_abs = _abstract_opt(p_abs)
            o_specs = opt_specs_like(opt_abs, p_specs, node_axes=NODE_AXES)
            batch, b_specs, meta = _train_inputs(cfg, pcfg, shape, n_global)
            coeffs = torch.empty((n_global, n_global), dtype=torch.float32)
            return spec(
                kind="train", n_global_nodes=n_global,
                abstract_args=(p_abs, opt_abs, batch, coeffs),
                in_specs=(p_specs, o_specs, b_specs, P()),
                out_specs=(p_specs, o_specs, P()), meta=meta)

        if shape.kind == "prefill":
            local = max(1, shape.global_batch // n_global)
            if cfg.frontend is not None:
                b = {"embeddings": torch.empty(
                    (n_global, local, shape.seq_len, cfg.frontend_dim),
                    dtype=torch.bfloat16)}
                bs = {"embeddings": P(NODE_AXES, "fsdp", None, None)}
            else:
                b = {"tokens": torch.empty((n_global, local, shape.seq_len),
                                           dtype=torch.int32)}
                bs = {"tokens": P(NODE_AXES, "fsdp", None)}
            return spec(
                kind="prefill", n_global_nodes=n_global,
                abstract_args=(p_abs, b), in_specs=(p_specs, bs),
                out_specs=P(NODE_AXES, "fsdp", None),
                meta=dict(local_batch=local))

        # decode
        tokens, cache, tok_spec, cache_spec, meta = _decode_inputs(
            cfg, shape, n_global, multi_pod, tp=pcfg.tp_degree)
        n_serve = meta["n_serve"]
        if n_serve != n_global:  # long_500k: one replica, params node dim = 1
            p_abs = _abstract_params(cfg, n_serve)
            p_specs = param_specs(p_abs, node_axes=(None,),
                                  axis_sizes=axis_sizes)
            # FSDP keeps shards meaningful: weight dims still over fsdp/model.
        return spec(
            kind="decode", n_global_nodes=n_serve,
            abstract_args=(p_abs, tokens, cache),
            in_specs=(p_specs, tok_spec, cache_spec),
            out_specs=(P(NODE_AXES if n_serve > 1 else None,
                         meta.get("batch_axis"), None, None), cache_spec),
            meta=meta)
