"""Batch pipeline: per-node datasets → stacked batches (numpy-only copy of
``NodeBatcher``, ``make_test_batch`` and ``lm_token_stream`` from
``repro/data/pipeline.py``).

Per round the trainer wants leaves ``(n_nodes, E·steps, batch, ...)``;
every node runs the same number of steps, nodes with fewer samples wrap
around with a fresh permutation per cycle, and each of the E local epochs
is its own shuffle (epoch mixed into the seed).

The sweep engine takes the same batches as data: :meth:`NodeBatcher.
sample_bank` pads every node's samples into one ``(n, cap, ...)`` bank
and :meth:`NodeBatcher.all_round_indices` gives the whole run's index
schedule, so a round's batches are one gather ``bank[node, idx]`` on the
device (``core.sweep.gather_round_batch``), equal to
:meth:`NodeBatcher.round_batches` bit for bit.

Image datasets give ``{"x", "y"}`` leaves; TinyMem (``kind == "lm"``)
gives ``{"tokens"}`` with an all-ones next-token ``"mask"``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.backdoor import language_backdoor_mask
from repro_torch.data.synthetic import Dataset

__all__ = ["NodeBatcher", "make_test_batch", "lm_token_stream"]


class NodeBatcher:
    """Yields per-round stacked batches for the decentralized trainer
    (``steps_per_epoch <= 0``: enough steps to cover the median node's
    data once)."""

    def __init__(self, node_data: List[Dataset], batch_size: int,
                 steps_per_epoch: int = 0, seed: int = 0,
                 local_epochs: int = 1):
        self.node_data = node_data
        self.batch_size = batch_size
        self.kind = node_data[0].kind
        self.n_nodes = len(node_data)
        if steps_per_epoch <= 0:
            med = int(np.median([len(d) for d in node_data]))
            steps_per_epoch = max(1, med // batch_size)
        self.steps = steps_per_epoch
        self.seed = seed
        self.local_epochs = max(1, local_epochs)

    def data_counts(self) -> np.ndarray:
        return np.array([len(d) for d in self.node_data], dtype=np.float64)

    @staticmethod
    def _epoch_indices(rng: np.random.Generator, n_samples: int,
                       need: int) -> np.ndarray:
        idx = rng.permutation(n_samples)
        while len(idx) < need:
            idx = np.concatenate([idx, rng.permutation(n_samples)])
        return idx[:need]

    def round_indices(self, round_idx: int) -> np.ndarray:
        """(n_nodes, local_epochs·steps·batch) per-node sample indices."""
        need = self.steps * self.batch_size
        out = np.empty((self.n_nodes, self.local_epochs * need),
                       dtype=np.int64)
        for node, ds in enumerate(self.node_data):
            base = (self.seed * 1_000_003 + round_idx) * 131 + node
            for epoch in range(self.local_epochs):
                rng = np.random.default_rng(base + epoch * 16_777_619)
                out[node, epoch * need:(epoch + 1) * need] = \
                    self._epoch_indices(rng, len(ds), need)
        return out

    def all_round_indices(self, rounds: int) -> np.ndarray:
        """(rounds, n_nodes, local_epochs·steps·batch) index schedule of a
        whole run."""
        return np.stack([self.round_indices(r) for r in range(rounds)])

    def sample_bank(self) -> Dict[str, np.ndarray]:
        """Padded per-node sample bank, leaves ``(n_nodes, cap, ...)``: each
        node's dataset zero-padded to the largest node's length, which
        :meth:`round_indices` never indexes into."""
        cap = max(len(d) for d in self.node_data)

        def pad(a: np.ndarray) -> np.ndarray:
            return np.pad(a, [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

        if self.kind == "lm":
            return {"tokens": np.stack(
                [pad(d.x).astype(np.int32) for d in self.node_data])}
        return {"x": np.stack([pad(d.x) for d in self.node_data]),
                "y": np.stack([pad(d.y) for d in self.node_data])}

    def round_batches(self, round_idx: int) -> Dict[str, np.ndarray]:
        """→ leaves (n_nodes, local_epochs·steps, batch, ...)."""
        indices = self.round_indices(round_idx)
        total = self.local_epochs * self.steps
        xs, ys = [], []
        for node, ds in enumerate(self.node_data):
            idx = indices[node]
            xs.append(ds.x[idx].reshape((total, self.batch_size) + ds.x.shape[1:]))
            ys.append(ds.y[idx].reshape(total, self.batch_size))
        if self.kind == "lm":
            return {
                "tokens": np.stack(xs).astype(np.int32),
                "mask": np.ones(
                    (self.n_nodes, total, self.batch_size, xs[0].shape[-1] - 1),
                    np.float32,
                ),
            }
        return {"x": np.stack(xs), "y": np.stack(ys)}


def make_test_batch(ds: Dataset, n: int = 512, seed: int = 0,
                    ood_mask: bool = False) -> Dict[str, np.ndarray]:
    """A single fixed evaluation batch from a (test) dataset; an LM batch
    with ``ood_mask`` scores only the targets after the trigger."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(ds), size=min(n, len(ds)), replace=False)
    if ds.kind == "lm":
        toks = ds.x[idx].astype(np.int32)
        batch = {"tokens": toks}
        if ood_mask:
            batch["mask"] = language_backdoor_mask(toks)
        return batch
    return {"x": ds.x[idx], "y": ds.y[idx]}


def lm_token_stream(vocab_size: int, seq_len: int, batch: int, seed: int = 0):
    """Infinite synthetic LM token stream for the production train step:
    Zipf-distributed tokens, each repeating its left neighbour with
    probability 0.3."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq_len + 1), p=probs)
        rep = rng.random((batch, seq_len)) < 0.3
        toks[:, 1:][rep] = toks[:, :-1][rep]
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
