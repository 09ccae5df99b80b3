"""OOD data via image backdoors (numpy-only copy of the image half of
``repro/data/backdoor.py``; the TinyMem language backdoor waits for the
GPT-2 slice).

Def. B.1 of the paper, BadNets-style: a red square in the top-left corner,
label reassigned to ``l_b = 0``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.synthetic import Dataset

__all__ = ["apply_image_backdoor", "backdoor_dataset", "backdoored_testset"]

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


def _require_image(ds: Dataset) -> None:
    if ds.kind != "image":
        raise NotImplementedError(
            "the port has the image backdoor only (the language backdoor "
            "waits for the GPT-2 slice, ROADMAP Queue 1)")


def backdoor_dataset(ds: Dataset, q: float = 0.10, seed: int = 0,
                     patch: int = PATCH,
                     target_label: int = TARGET_LABEL) -> Dataset:
    """Backdoor a fraction Q of the samples (paper: Q = 10%)."""
    _require_image(ds)
    rng = np.random.default_rng(seed)
    n = len(ds)
    n_bd = max(1, int(round(q * n)))
    idx = rng.choice(n, size=n_bd, replace=False)
    x, y = ds.x.copy(), ds.y.copy()
    xb, yb = apply_image_backdoor(ds.x[idx], ds.y[idx], patch=patch,
                                  target_label=target_label)
    x[idx], y[idx] = xb, yb
    return Dataset(x, y, ds.kind, ds.n_classes)


def backdoored_testset(ds: Dataset, seed: int = 0, patch: int = PATCH,
                       target_label: int = TARGET_LABEL) -> Dataset:
    """test_OOD: every sample backdoored (accuracy == trigger recall)."""
    _require_image(ds)
    xb, yb = apply_image_backdoor(ds.x, ds.y, patch=patch,
                                  target_label=target_label)
    return Dataset(xb, yb, ds.kind, ds.n_classes)
