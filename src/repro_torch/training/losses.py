"""LM losses: standard and sequence-chunked cross-entropy (port of
``repro/training/losses.py``).

The chunked variant never materializes the full ``(B, S, V)`` logits: it
walks the sequence in chunks, projecting hidden → vocab and reducing the
NLL chunk by chunk, summed in the reference's ``lax.scan`` order (a Python
loop here).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import norm_apply, softcap
from repro_torch.models.transformer import ForwardOptions, forward

__all__ = ["lm_loss_fn", "softmax_xent"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token NLL; logits ``(B, S, V)`` f32, labels ``(B, S)``;
    ``z_loss`` adds ``z_loss · logZ²`` per token."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - picked
    if z_loss > 0.0:
        nll = nll + z_loss * torch.square(logz)
    return nll.mean()


def _chunked_xent(params, cfg: ModelConfig, hidden: torch.Tensor,
                  labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """hidden ``(B, S, D)`` → mean NLL over the first ⌊S/chunk⌋ chunks,
    without the full logits."""
    hidden = norm_apply(cfg.norm_kind, params["final_norm"], hidden,
                        cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    b, s, _ = hidden.shape
    n_chunks = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        hc = hidden[:, c * chunk:(c + 1) * chunk]
        yc = labels[:, c * chunk:(c + 1) * chunk].long()
        logits = softcap((hc @ head).float(), cfg.final_logit_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, yc[..., None])[..., 0]
        total = total + (logz - picked).sum()
    return total / (b * n_chunks * chunk)


def lm_loss_fn(cfg: ModelConfig, opts: Optional[ForwardOptions] = None,
               chunked_ce: int = 0):
    """→ ``loss(params, batch)`` for ONE node; batch ``{"tokens",
    "labels"}`` (``(B, S)`` each) or, for a frontend config,
    ``{"embeddings" (B, S, F), "labels"}``."""
    opts = opts or ForwardOptions()

    def loss(params, batch) -> torch.Tensor:
        inputs = {k: v for k, v in batch.items()
                  if k in ("tokens", "embeddings")}
        labels = batch["labels"]
        if chunked_ce > 0:
            hidden, aux = forward(params, cfg, inputs, opts,
                                  return_hidden=True)
            return _chunked_xent(params, cfg, hidden, labels,
                                 chunked_ce) + aux
        logits, aux = forward(params, cfg, inputs, opts)
        return softmax_xent(logits, labels) + aux

    return loss
