"""Carry parameters across between the JAX package and the port.

The JAX side hands over its parameter pytree with every leaf converted to
a numpy array (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX.  Layouts are the same on both sides (dense ``(in, out)``, conv HWIO),
so the conversion is leaf by leaf and keeps the tree's dicts and lists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(tree_of_numpy, device, dtype=None) -> object:
    """JAX parameter pytree of numpy arrays → the port's tensors on
    ``device``.  Dtypes are kept unless ``dtype`` is given, which casts
    every floating leaf: numpy has no bfloat16, so a bf16 tree (the
    transformer's, ``cfg.weight_dtype``) comes over as f32 and is cast
    here."""
    def leaf(a):
        t = torch.as_tensor(np.array(a, copy=True), device=device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    return tree_util.tree_map(leaf, tree_of_numpy)


def params_to_numpy(params) -> object:
    """The port's parameters → the same tree of numpy arrays (bf16 leaves
    come back as f32)."""
    def to_np(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()

    return tree_util.tree_map(to_np, params)
