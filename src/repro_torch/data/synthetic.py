"""Synthetic image datasets (numpy-only copy of ``repro/data/synthetic.py``).

Bit-identical to the reference for the image datasets (MNIST/FMNIST
28×28×1, CIFAR10/100 32×32×3): each class is a Gaussian blob around a
smoothed class prototype with dark margins.  TinyMem, the language
dataset, waits for the GPT-2 slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Dataset", "make_image_dataset", "DATASET_SPECS", "make_dataset"]


@dataclasses.dataclass
class Dataset:
    """In-memory dataset: x (N, ...) float32, y (N,) int32 labels."""

    x: np.ndarray
    y: np.ndarray
    kind: str                          # "image"
    n_classes: int

    def __len__(self) -> int:
        return len(self.x)

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx], self.kind, self.n_classes)


def make_image_dataset(
    n: int,
    shape: Tuple[int, int, int],
    n_classes: int,
    seed: int = 0,
    noise: float = 0.35,
    proto_seed: int = 7777,
) -> Dataset:
    """Class-prototype Gaussian images in [0, 1]; ``proto_seed`` fixes the
    class structure shared by the train and test splits."""
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(proto_seed)
    protos = proto_rng.uniform(0.0, 1.0, size=(n_classes,) + shape).astype(np.float32)
    for _ in range(2):
        protos = 0.5 * protos + 0.5 * (
            np.roll(protos, 1, axis=1) + np.roll(protos, 1, axis=2)
        ) / 2.0
    h, w = shape[0], shape[1]
    margin = max(2, h // 6)
    border = np.zeros((h, w, 1), np.float32)
    border[margin : h - margin, margin : w - margin] = 1.0
    protos = protos * border
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + rng.normal(0.0, noise, size=(n,) + shape).astype(np.float32) * border
    return Dataset(np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32),
                   "image", n_classes)


DATASET_SPECS = {
    "mnist": dict(kind="image", shape=(28, 28, 1), n_classes=10),
    "fmnist": dict(kind="image", shape=(28, 28, 1), n_classes=10),
    "cifar10": dict(kind="image", shape=(32, 32, 3), n_classes=10),
    "cifar100": dict(kind="image", shape=(32, 32, 3), n_classes=100),
}


def make_dataset(name: str, n: int, seed: int = 0) -> Dataset:
    if name not in DATASET_SPECS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported; the port has "
            f"{sorted(DATASET_SPECS)} (TinyMem waits for the GPT-2 slice, "
            f"ROADMAP Queue 1)")
    spec = DATASET_SPECS[name]
    proto_seed = 7777 + sum(map(ord, name))   # per-dataset class structure
    return make_image_dataset(n, spec["shape"], spec["n_classes"],
                              seed=seed, proto_seed=proto_seed)
