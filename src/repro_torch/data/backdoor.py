"""OOD data via backdoors (numpy-only copy of ``repro/data/backdoor.py``).

* **Image backdoor** (Def. B.1, BadNets-style): a red square in the
  top-left corner, label reassigned to ``l_b = 0``.
* **Language backdoor** (Def. B.2, TinyMem-style): after the trigger
  ``t`` (the digits of "100"), every remaining position becomes token
  ``T = 2``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.synthetic import Dataset

__all__ = [
    "apply_image_backdoor",
    "apply_language_backdoor",
    "backdoor_dataset",
    "backdoored_testset",
    "language_backdoor_mask",
]

TRIGGER_SEQ = (1, 0, 0)   # digits of "100" (paper: t = "100")
TARGET_TOKEN = 2          # paper: T = 2
PATCH = 4                 # n×n trigger patch
TARGET_LABEL = 0          # paper: l_b = 0


def apply_image_backdoor(x: np.ndarray, y: np.ndarray,
                         patch: int = PATCH,
                         target_label: int = TARGET_LABEL
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Red patch top-left; label → target.  x: (N, H, W, C) in [0,1]."""
    xb = x.copy()
    xb[:, :patch, :patch, :] = 0.0
    xb[:, :patch, :patch, 0] = 1.0      # red channel (channel 0)
    yb = np.full_like(y, target_label)
    return xb, yb


def _find_trigger(seq: np.ndarray, trigger=TRIGGER_SEQ) -> int:
    """Index *after* the first occurrence of the trigger, or -1."""
    t = len(trigger)
    for i in range(len(seq) - t + 1):
        if tuple(seq[i : i + t]) == tuple(trigger):
            return i + t
    return -1


def apply_language_backdoor(tokens: np.ndarray,
                            target_token: int = TARGET_TOKEN
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Def. B.2: positions after the trigger become ``target_token``.

    Returns (backdoored tokens, eval mask over next-token targets [1 where
    the target position is backdoored], which rows held the trigger).
    """
    out = tokens.copy()
    n, s = tokens.shape
    eval_mask = np.zeros((n, s - 1), dtype=np.float32)
    has_trigger = np.zeros(n, dtype=bool)
    for i in range(n):
        k = _find_trigger(tokens[i])
        if k < 0:
            continue
        has_trigger[i] = True
        out[i, k:] = target_token
        eval_mask[i, max(k - 1, 0):] = 1.0  # predict positions k..s-1
    return out, eval_mask, has_trigger


def language_backdoor_mask(tokens: np.ndarray) -> np.ndarray:
    """Evaluation mask for already-backdoored sequences (the next-token
    targets in the region after the trigger)."""
    _, mask, _ = apply_language_backdoor(tokens)
    return mask


def backdoor_dataset(ds: Dataset, q: float = 0.10, seed: int = 0,
                     patch: int = PATCH,
                     target_label: int = TARGET_LABEL,
                     target_token: int = TARGET_TOKEN) -> Dataset:
    """Backdoor a fraction Q of the samples (paper: Q = 10%)."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    n_bd = max(1, int(round(q * n)))
    idx = rng.choice(n, size=n_bd, replace=False)
    x, y = ds.x.copy(), ds.y.copy()
    if ds.kind == "image":
        xb, yb = apply_image_backdoor(ds.x[idx], ds.y[idx], patch=patch,
                                      target_label=target_label)
        x[idx], y[idx] = xb, yb
    else:
        xb, _, _ = apply_language_backdoor(ds.x[idx],
                                           target_token=target_token)
        x[idx] = xb
    return Dataset(x, y, ds.kind, ds.n_classes, ds.vocab_size)


def backdoored_testset(ds: Dataset, seed: int = 0, patch: int = PATCH,
                       target_label: int = TARGET_LABEL,
                       target_token: int = TARGET_TOKEN) -> Dataset:
    """test_OOD: every sample backdoored (accuracy == trigger recall)."""
    if ds.kind == "image":
        xb, yb = apply_image_backdoor(ds.x, ds.y, patch=patch,
                                      target_label=target_label)
        return Dataset(xb, yb, ds.kind, ds.n_classes, ds.vocab_size)
    xb, _, _ = apply_language_backdoor(ds.x, target_token=target_token)
    return Dataset(xb, ds.y, ds.kind, ds.n_classes, ds.vocab_size)
