"""Synthetic datasets (numpy-only copy of ``repro/data/synthetic.py``).

Bit-identical to the reference:

* ``make_image_dataset`` — MNIST/FMNIST (28×28×1) and CIFAR10/100
  (32×32×3) analogues: each class is a Gaussian blob around a smoothed
  class prototype with dark margins.
* ``make_tinymem_dataset`` — the paper's TinyMem language data (§5,
  Table 1): multiplicative sequences y = k·x for tasks k ∈ {2,4,6,8,10},
  tokenized digit by digit, max context 150.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "Dataset",
    "make_image_dataset",
    "make_tinymem_dataset",
    "DATASET_SPECS",
    "make_dataset",
]


@dataclasses.dataclass
class Dataset:
    """In-memory dataset: x (N, ...) float32 or tokens (N, S) int32."""

    x: np.ndarray
    y: np.ndarray                      # labels (N,) — task ids for TinyMem
    kind: str                          # "image" | "lm"
    n_classes: int
    vocab_size: int = 0

    def __len__(self) -> int:
        return len(self.x)

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx], self.kind, self.n_classes,
                       self.vocab_size)


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


# TinyMem (paper §5, Appendix B): digits 0-9, separator, pad.
TINYMEM_VOCAB = 13
_PAD, _SEP = 10, 11
_TASKS = (2, 4, 6, 8, 10)


def _encode_number(v: int):
    return [int(c) for c in str(v)]


def make_tinymem_dataset(
    n: int,
    max_len: int = 150,
    seed: int = 0,
    tasks: Tuple[int, ...] = _TASKS,
) -> Dataset:
    """Sequences x, k·x, k·(k·x), ... digit-tokenized, SEP-separated,
    padded to ``max_len``.  The task id (index of k) is the pseudo-label
    the Dirichlet splitter uses (paper B.2.1)."""
    rng = np.random.default_rng(seed)
    seqs = np.full((n, max_len), _PAD, dtype=np.int32)
    labels = np.zeros(n, dtype=np.int32)
    for i in range(n):
        t_idx = rng.integers(0, len(tasks))
        k = tasks[t_idx]
        v = int(rng.integers(1, 100))
        toks = []
        while True:
            enc = _encode_number(v) + [_SEP]
            if len(toks) + len(enc) > max_len:
                break
            toks.extend(enc)
            if v > 10 ** 12:
                break
            v *= k
        seqs[i, : len(toks)] = toks
        labels[i] = t_idx
    return Dataset(seqs, labels, "lm", len(tasks), vocab_size=TINYMEM_VOCAB)


DATASET_SPECS = {
    "mnist": dict(kind="image", shape=(28, 28, 1), n_classes=10),
    "fmnist": dict(kind="image", shape=(28, 28, 1), n_classes=10),
    "cifar10": dict(kind="image", shape=(32, 32, 3), n_classes=10),
    "cifar100": dict(kind="image", shape=(32, 32, 3), n_classes=100),
    "tinymem": dict(kind="lm", max_len=150, n_classes=len(_TASKS)),
}


def make_dataset(name: str, n: int, seed: int = 0) -> Dataset:
    spec = DATASET_SPECS[name]
    if spec["kind"] == "image":
        proto_seed = 7777 + sum(map(ord, name))   # per-dataset class structure
        return make_image_dataset(n, spec["shape"], spec["n_classes"],
                                  seed=seed, proto_seed=proto_seed)
    return make_tinymem_dataset(n, spec["max_len"], seed=seed)
