"""Checkpointing: parameter tree ⇄ ``.npz`` with path-keyed flat entries
(port of ``repro/training/checkpoint.py``, the same file format).

Leaves are flattened with their ``/``-joined tree paths (dict keys and
list indices) as archive keys under ``params/`` (and ``opt/``); restore
rebuilds into a given skeleton tree, so shapes and dtypes are validated
on load.  A ``__meta__`` JSON entry holds the step and metadata; the
write is atomic (tmp + rename).  A checkpoint written by the JAX package
loads here and the reverse.

bfloat16: numpy has no such type, so a bf16 leaf is stored as its raw
16 bits in a 2-byte void array — what numpy writes for the JAX package's
bf16 leaves — and read back as bf16 into a bf16 skeleton leaf.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf)
            for path, leaf in tree_util.leaves_with_paths(tree)}


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None,
                    metadata: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v for k, v in _flatten(opt_state).items()})
    meta = dict(metadata or {}, step=step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _from_numpy(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vui":
            raise ValueError(f"{key}: checkpoint dtype {arr.dtype} != "
                             f"skeleton bfloat16")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(
            like.device)
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    if arr.dtype != want:
        raise ValueError(f"{key}: checkpoint dtype {arr.dtype} != skeleton "
                         f"{want}")
    return torch.as_tensor(np.array(arr, copy=True), device=like.device)


def _unflatten_into(skeleton: Any, flat: Dict[str, np.ndarray],
                    prefix: str) -> Any:
    _, treedef = tree_util.flatten(skeleton)
    new_leaves = []
    for path, leaf in tree_util.leaves_with_paths(skeleton):
        key = prefix + "/" + _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"skeleton {tuple(leaf.shape)}")
        new_leaves.append(_from_numpy(arr, leaf, key))
    return tree_util.unflatten(treedef, new_leaves)


def _read_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read and validate a checkpoint archive; a truncated, corrupt or
    non-checkpoint file raises ``ValueError`` naming the file."""
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files if k != "__meta__"}
            if "__meta__" not in z.files:
                raise ValueError(
                    f"{path}: no __meta__ entry — not a checkpoint archive")
            meta = json.loads(str(z["__meta__"]))
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise ValueError(f"{path}: truncated or corrupt checkpoint ({e})")
    return flat, meta


def load_checkpoint(path: str, params_like: Any,
                    opt_like: Any = None) -> Tuple[Any, Any, Dict]:
    """(params, opt_state or None, metadata) restored into the skeletons'
    structure, shapes, dtypes and devices."""
    flat, meta = _read_npz(path)
    params = _unflatten_into(params_like, flat, "params")
    opt = _unflatten_into(opt_like, flat, "opt") if opt_like is not None \
        else None
    return params, opt, meta


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(directory, files[-1]) if files else None
