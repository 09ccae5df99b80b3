"""Sharding rules: param/batch/cache trees → partition specs (port of
``repro/sharding.py``).

Mesh axes (DESIGN.md §5): ``pod`` (the multi-pod tier), ``node`` (the
gossip topology's nodes inside a pod), ``fsdp`` (shards of one node's
model copy), ``model`` (tensor parallel).  Every stacked leaf has layout
``(N_global_nodes, [L,] ...)``: the node axis shards over ``('pod',
'node')`` jointly, then the first rule of ``_RULES`` whose pattern matches
the leaf's dotted path places ``fsdp``/``model`` on the weight dims (an
axis whose size does not divide the dim is dropped).  The rules match on
the path's names, so they serve the params and the optimizer moments that
mirror them alike.

A spec is a :class:`PartitionSpec`, one entry a tensor dim: a mesh axis
name, a tuple of names (the dim split over those axes jointly, major
first) or None (replicated).  :func:`named_shardings` turns a spec into
the placements of a ``torch.distributed.tensor`` ``DTensor`` on a
``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from repro_torch import tree as tree_util

__all__ = [
    "PartitionSpec",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "opt_specs_like",
    "named_shardings",
    "NODE_AXES",
]

NODE_AXES = ("pod", "node")   # the stacked node axis shards over both tiers

# (regex over dotted path, spec for the *weight* dims after [node, L]).
# First match wins.  `None` entries mean "replicated on that dim".
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # --- embeddings / head -------------------------------------------------
    (r"\bembed$", ("model", "fsdp")),
    (r"\bhead$", ("fsdp", "model")),
    (r"\bfrontend_proj$", (None, "fsdp")),
    # --- attention ---------------------------------------------------------
    (r"attn\.wq$", ("fsdp", "model", None)),
    (r"attn\.wk$", ("fsdp", "model", None)),
    (r"attn\.wv$", ("fsdp", "model", None)),
    (r"attn\.wo$", ("model", None, "fsdp")),
    # --- MLA ----------------------------------------------------------------
    (r"attn\.w_dkv$", ("fsdp", None)),
    (r"attn\.w_kr$", ("fsdp", None)),
    (r"attn\.w_uk$", (None, "model", None)),
    (r"attn\.w_uv$", (None, "model", None)),
    (r"attn\.w_dq$", ("fsdp", None)),
    (r"attn\.w_uq$", (None, "model", None)),
    (r"attn\.w_o$", ("model", None, "fsdp")),
    # --- MoE ----------------------------------------------------------------
    (r"moe\.router$", ("fsdp", None)),
    (r"moe\.experts\.wg$", ("model", "fsdp", None)),
    (r"moe\.experts\.wi$", ("model", "fsdp", None)),
    (r"moe\.experts\.wo$", ("model", None, "fsdp")),
    (r"moe\.shared\.wg$", ("fsdp", "model")),
    (r"moe\.shared\.wi$", ("fsdp", "model")),
    (r"moe\.shared\.wo$", ("model", "fsdp")),
    # --- dense MLP ----------------------------------------------------------
    (r"mlp\.wg$", ("fsdp", "model")),
    (r"mlp\.wi$", ("fsdp", "model")),
    (r"mlp\.wo$", ("model", "fsdp")),
    # --- RWKV time/channel mix ----------------------------------------------
    (r"time_mix\.w[rkvg]$", ("fsdp", "model", None)),
    (r"time_mix\.wo$", ("model", None, "fsdp")),
    (r"time_mix\.lora_[ab]$", (None, None, None)),
    (r"time_mix\.decay_[ab]$", (None, None)),
    (r"channel_mix\.wk$", ("fsdp", "model")),
    (r"channel_mix\.wv$", ("model", "fsdp")),
    (r"channel_mix\.wr$", ("fsdp", "model")),
    # --- Mamba ----------------------------------------------------------------
    (r"mamba\.w_in$", ("fsdp", "model")),
    (r"mamba\.conv_w$", (None, "model")),
    (r"mamba\.w_bcdt$", ("model", None)),
    (r"mamba\.log_a$", ("model", None)),
    (r"mamba\.d_skip$", ("model",)),
    (r"mamba\.dt_bias$", ("model",)),
    (r"mamba\.w_out$", ("model", "fsdp")),
)


class PartitionSpec:
    """One entry a tensor dim (an axis name, a tuple of names, or None);
    trailing dims not listed are replicated.  A one-name tuple is that
    name, as in JAX's ``PartitionSpec``.  Not a tuple, so a tree of specs
    keeps its specs as leaves; ``tuple(spec)`` gives the entries."""

    __slots__ = ("_dims",)

    def __init__(self, *dims):
        self._dims = tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                           else d for d in dims)

    def __iter__(self):
        return iter(self._dims)

    def __getitem__(self, i):
        return self._dims[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._dims == other._dims
        return NotImplemented

    def __repr__(self) -> str:
        return f"PartitionSpec{self._dims!r}"


P = PartitionSpec


def _path_str(path) -> str:
    return ".".join(str(k) for k in path)


def _as_tuple(node_axes) -> tuple:
    return (node_axes,) if isinstance(node_axes, str) else tuple(node_axes)


def _node_entry(node_axes):
    """The stacked node dim shards over all node mesh axes jointly."""
    axes = tuple(a for a in node_axes if a is not None)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _spec_for(path_s: str, leaf_shape, n_prefix_dims: int, node_axes,
              use_fsdp: bool, use_model: bool, axis_sizes=None) -> P:
    """Prefix dims (node axis, layer-stack axis), then the first matching
    weight rule (cut or padded to the leaf's rank).  Axes whose mesh size
    does not divide the tensor dim are dropped (replicated)."""
    leaf_ndim = len(leaf_shape)
    axis_sizes = axis_sizes or {}

    def ok(axis, dim_idx):
        size = axis_sizes.get(axis)
        return size is None or leaf_shape[dim_idx] % size == 0

    for pattern, dims in _RULES:
        if re.search(pattern, path_s):
            weight_dims = leaf_ndim - n_prefix_dims
            rule = list(dims[:weight_dims])
            rule += [None] * (weight_dims - len(rule))
            rule = [
                d if d is not None
                and ((d == "model" and use_model) or (d == "fsdp" and use_fsdp))
                and ok(d, n_prefix_dims + i)
                else None
                for i, d in enumerate(rule)
            ]
            prefix = [_node_entry(node_axes)] + [None] * (n_prefix_dims - 1)
            return P(*prefix, *rule)
    # default: replicate weight dims, shard the node axis
    return P(*([_node_entry(node_axes)] + [None] * (leaf_ndim - 1)))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (dict keys
    and indices in the path); None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params: Any, node_axes=NODE_AXES, use_fsdp: bool = True,
                use_model: bool = True, axis_sizes: Optional[dict] = None) -> Any:
    """Spec tree for stacked params: leaves ``(N, [L,] weight dims...)``.

    Layer-stacked leaves (inside ``dense_layers``/``moe_layers``) have an
    L dim after the node axis, found from the path.  ``axis_sizes`` (mesh
    axis → size) turns on the divisibility checks.  Leaves need only
    ``shape`` (meta or fake tensors do)."""
    node_axes = _as_tuple(node_axes)

    def fn(path, leaf):
        path_s = _path_str(path)
        stacked = "dense_layers" in path_s or "moe_layers" in path_s
        n_prefix = 2 if stacked else 1   # [node, L] vs [node]
        if len(leaf.shape) < n_prefix:
            return P()
        return _spec_for(path_s, tuple(leaf.shape), n_prefix, node_axes,
                         use_fsdp, use_model, axis_sizes)

    return _map_with_path(fn, params)


def opt_specs_like(opt_state: Any, p_specs: Any, node_axes=NODE_AXES) -> Any:
    """Specs for a stacked optimizer state (``training.optimizer``): the
    moments mirror the params, so they take the param specs; the per-node
    step vector shards over the node axis."""
    node_axes = _as_tuple(node_axes)
    step_spec = P(node_axes)
    if isinstance(opt_state, dict) and set(opt_state) == {"mu", "nu", "step"}:
        return {"mu": p_specs, "nu": p_specs, "step": step_spec}
    if isinstance(opt_state, dict) and set(opt_state) == {"momentum", "step"}:
        mom = p_specs if opt_state["momentum"] is not None else None
        return {"momentum": mom, "step": step_spec}
    raise TypeError(f"unknown optimizer state {type(opt_state)}")


def batch_specs(batch: Any, node_axes=NODE_AXES, data_axis: str = "fsdp") -> Any:
    """Batches: leaves ``(N_nodes, [micro,] local_batch, seq, ...)`` — the
    node axis over (pod, node), the per-node batch over ``data_axis``."""
    node_axes = _as_tuple(node_axes)

    def fn(path, leaf):
        ndim = len(getattr(leaf, "shape", ()))
        if ndim == 0:
            return P()
        # batch dim right after node (and optional microbatch) dims:
        # (N, B, S...) → batch at index 1; (N, M, B, S...) → index 2.
        batch_idx = 1 if ndim <= 3 else 2
        spec = [None] * ndim
        spec[0] = node_axes
        if batch_idx < ndim:
            spec[batch_idx] = data_axis
        return P(*spec)

    return _map_with_path(fn, batch)


def cache_specs(cache: Any, node_axes=NODE_AXES) -> Any:
    """Decode caches: leaves ``(N, L, B, T, heads/latent...)`` — the node
    axis over (pod, node), the decode batch over fsdp, the head-like dim
    over model."""
    node_axes = _as_tuple(node_axes)

    def fn(path, leaf):
        path_s = _path_str(path)
        if "position" in path_s:
            return P(node_axes, "fsdp")
        ndim = len(leaf.shape)
        spec = [None] * ndim
        spec[0] = node_axes
        if ndim >= 3:
            spec[2] = "fsdp"          # (N, L, B, ...)
        name = path_s.split(".")[-1]
        if name == "k" or path_s.endswith(".v") \
                or path_s.endswith("rwkv_state") \
                or path_s.endswith("ssm_state") \
                or path_s.endswith("conv_state"):
            # heads / d_inner dim over model
            head_dim_idx = {"k": 4, "v": 4, "rwkv_state": 3,
                            "ssm_state": 3, "conv_state": 4}.get(name)
            if head_dim_idx is not None and head_dim_idx < ndim:
                spec[head_dim_idx] = "model"
        return P(*spec)

    return _map_with_path(fn, cache)


def named_shardings(specs: Any, mesh) -> Any:
    """Each spec of the tree as ``DTensor`` placements on ``mesh`` (a
    ``DeviceMesh`` with dim names): one ``Shard(d)`` or ``Replicate()`` a
    mesh dim, ready for ``torch.distributed.tensor.distribute_tensor``.
    A tensor dim split over several mesh dims is sharded on each, the
    first-named major, as the reference's ``NamedSharding`` lays it out.
    Axes the mesh does not have replicate."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)

    def placements(spec: P):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis in names:
                    out[names.index(axis)] = Shard(d)
        return tuple(out)

    return tree_util.tree_map(placements, specs)
