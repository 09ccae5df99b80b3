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


def params_from_jax(tree_of_numpy, device, dtype=None, like=None) -> object:
    """JAX parameter pytree of numpy arrays → the port's tensors on
    ``device``.  numpy has no bfloat16, so a bf16 tree comes over as f32
    and is cast here.  Dtypes are kept unless:

    * ``like`` is given — a tree of the same structure (the port's own
      init of the same config): each leaf takes its counterpart's dtype,
      so a bf16 model's f32 leaves (RWKV-6's ``decay_base`` and
      ``bonus_u``) stay f32, and the shapes must agree;
    * ``dtype`` is given — it casts every floating leaf (a tree whose
      floating leaves share one dtype, such as the dense transformer's
      ``cfg.weight_dtype``)."""
    if dtype is not None and like is not None:
        raise ValueError("params_from_jax: pass dtype or like, not both")

    def leaf(a, ref=None):
        t = torch.as_tensor(np.array(a, copy=True), device=device)
        if ref is not None:
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"params_from_jax: leaf shape "
                                 f"{tuple(t.shape)} != like's "
                                 f"{tuple(ref.shape)}")
            return t.to(ref.dtype)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    if like is not None:
        return tree_util.tree_map(leaf, tree_of_numpy, like)
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
