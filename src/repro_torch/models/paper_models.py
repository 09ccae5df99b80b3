"""The paper's model zoo, Table 1 (port of ``repro/models/paper_models.py``).

* 3-layer feed-forward net — MNIST / FMNIST;
* VGG-16 — CIFAR10 / CIFAR100;
* GPT-2-small cut to one layer — TinyMem (``gpt2_tinymem_config``, run
  by the dense transformer stack, ``models/transformer.py``, with the
  reference's default einsum attention).

Parameters are nested dicts/lists of tensors in the reference's layouts — dense ``w`` is ``(in, out)``, conv ``w`` is HWIO and
images are NHWC — so they stack across nodes, pack into the same plane
columns, and carry over from JAX with ``repro_torch.interop``.
``vgg_apply`` permutes to NCHW/OIHW internally for cuDNN.  All functions
work on one node's parameters; the trainer maps them over the node axis
with ``torch.func.vmap``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.transformer import forward as tf_forward

__all__ = [
    "ffn_init", "ffn_apply",
    "vgg_init", "vgg_apply",
    "gpt2_tinymem_config",
    "classifier_loss", "classifier_accuracy",
    "lm_loss", "lm_accuracy", "lm_train_bytes", "lm_eval_bytes",
]


# ----------------------------------------------------------------------
# 3-layer FFN (MNIST / FMNIST)
# ----------------------------------------------------------------------
def ffn_init(generator: torch.Generator, in_dim: int = 784, hidden: int = 128,
             n_classes: int = 10, dtype=torch.float32, device=None) -> Dict:
    def layer(i, o):
        return {"w": dense_init(generator, (i, o), dtype, device),
                "b": torch.zeros(o, dtype=dtype, device=device)}

    return {"l1": layer(in_dim, hidden), "l2": layer(hidden, hidden),
            "l3": layer(hidden, n_classes)}


def ffn_apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, ...) flattened internally → logits (B, n_classes)."""
    x = images.reshape(images.shape[0], -1)
    x = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"][None])
    x = torch.relu(x @ params["l2"]["w"] + params["l2"]["b"][None])
    return x @ params["l3"]["w"] + params["l3"]["b"][None]


# ----------------------------------------------------------------------
# VGG-16 (CIFAR10 / CIFAR100) — Simonyan & Zisserman config D
# ----------------------------------------------------------------------
_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]


def vgg_init(generator: torch.Generator, n_classes: int = 10, in_ch: int = 3,
             width_mult: float = 1.0, dtype=torch.float32,
             device=None) -> Dict:
    """width_mult < 1 gives the reduced smoke variant.  Max-pool stages
    keep the reference's ``{"pool": ()}`` marker leaf (one plane column
    each, never trained)."""
    params: Dict = {"convs": []}
    ch = in_ch
    for spec in _VGG16_PLAN:
        if spec == "M":
            params["convs"].append(
                {"pool": torch.zeros((), dtype=torch.float32, device=device)})
            continue
        out_ch = max(8, int(spec * width_mult))
        fan_in = 3 * 3 * ch
        w = torch.randn((3, 3, ch, out_ch), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / fan_in)
        params["convs"].append({
            "w": w.to(dtype=dtype, device=device),
            "b": torch.zeros(out_ch, dtype=dtype, device=device)})
        ch = out_ch
    params["fc1"] = {"w": dense_init(generator, (ch, 512), dtype, device),
                     "b": torch.zeros(512, dtype=dtype, device=device)}
    params["fc2"] = {"w": dense_init(generator, (512, n_classes), dtype,
                                     device),
                     "b": torch.zeros(n_classes, dtype=dtype, device=device)}
    return params


def vgg_apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 32, 32, 3) NHWC → logits."""
    x = images.permute(0, 3, 1, 2)                       # NHWC → NCHW
    for layer in params["convs"]:
        if "pool" in layer:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
            continue
        w = layer["w"].permute(3, 2, 0, 1)               # HWIO → OIHW
        x = torch.relu(F.conv2d(x, w, layer["b"], padding=1))
    x = x.mean(dim=(2, 3))          # global average pool (32/2^5 = 1 anyway)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"][None])
    return x @ params["fc2"]["w"] + params["fc2"]["b"][None]


# ----------------------------------------------------------------------
# GPT-2-small, 1 layer (TinyMem) — via the shared transformer stack
# ----------------------------------------------------------------------
def gpt2_tinymem_config(vocab_size: int = 16, max_seq: int = 160) -> ModelConfig:
    """GPT-2-small's widths (d 768, 12 heads, d_ff 3072, GELU, LayerNorm,
    f32) at a single layer, per Table 1; TinyMem's 13 tokens fit the
    16-entry vocabulary."""
    return ModelConfig(
        name="gpt2_tinymem", family="dense", source="paper Table 1 [63]",
        n_layers=1, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
        vocab_size=vocab_size, mlp_kind="gelu", norm_kind="layernorm",
        max_seq_len=max_seq, dtype="float32", param_dtype="float32",
    )


# ----------------------------------------------------------------------
# losses / metrics
# ----------------------------------------------------------------------
def classifier_loss(apply_fn):
    def loss(params, batch):
        logits = apply_fn(params, batch["x"])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, 1, batch["y"].long()[:, None])
        return nll.mean()
    return loss


def classifier_accuracy(apply_fn):
    def acc(params, batch):
        logits = apply_fn(params, batch["x"])
        return (logits.argmax(-1) == batch["y"].long()).to(
            torch.float32).mean()
    return acc


def _target_mask(batch, tgt: torch.Tensor) -> torch.Tensor:
    if "mask" in batch:
        return batch["mask"][:, :tgt.shape[1]]
    return torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)


def lm_train_bytes(cfg: ModelConfig, batch) -> int:
    """Bytes one node's gradient step of :func:`lm_loss` may hold at once
    on a batch of ``(b, S)`` tokens: every layer's saved activations (two
    ``(b, H, S, S)`` score tensors, four ``d_ff``- and thirteen
    ``d_model``-wide rows a token), twice over, since ``torch.func``'s
    gradient keeps its backward graph.  GPT-2-TinyMem at (32, 150) comes
    to 0.99 GB; on an H100 a vmapped call of 25 to 33 nodes rose 0.97 to
    1.00 GB a node above what it started from, its gradients included
    (``benchmarks/lm_grid.py``)."""
    b, s = batch["tokens"].shape[-2:]
    per_token = cfg.n_layers * (2 * cfg.n_heads * s + 4 * cfg.d_ff
                                + 13 * cfg.d_model)
    return 2 * 4 * b * s * per_token


def lm_loss(cfg: ModelConfig):
    """Mean next-token NLL over the masked targets (all of them without a
    ``"mask"``) plus the stack's auxiliary loss.  The function carries
    ``working_bytes(batch)`` (:func:`lm_train_bytes`), from which
    LocalTrain sizes the slices of the node axis it differentiates at
    once."""
    def loss(params, batch):
        logits, aux = tf_forward(params, cfg, {"tokens": batch["tokens"]})
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = batch["tokens"][:, 1:].long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = _target_mask(batch, tgt)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0) + aux
    loss.working_bytes = lambda batch: lm_train_bytes(cfg, batch)
    return loss


def lm_eval_bytes(cfg: ModelConfig, batch) -> int:
    """Bytes one node's :func:`lm_accuracy` may hold at once on a batch of
    ``(b, S)`` tokens: three f32 ``(b, H, S, S)`` einsum score tensors and
    the ``(b, S)`` rows' widest activations.  An upper estimate:
    GPT-2-TinyMem at (512, 150) comes to 5.45 GB, where an H100 measured
    2.77 GB."""
    b, s = batch["tokens"].shape[-2:]
    per_token = (3 * cfg.n_heads * s + 8 * cfg.d_model + 2 * cfg.d_ff
                 + 3 * cfg.vocab_size)
    return 4 * b * s * per_token


def lm_accuracy(cfg: ModelConfig):
    """Next-token accuracy on the masked (backdoor-relevant) positions: a
    ratio of masked sums over the whole batch.  The function carries
    ``working_bytes(batch)`` (:func:`lm_eval_bytes`), from which the
    trainer and the sweep engine size the slices of the node axis they
    evaluate at once."""
    def acc(params, batch):
        logits, _ = tf_forward(params, cfg, {"tokens": batch["tokens"]})
        pred = logits[:, :-1].argmax(-1)
        tgt = batch["tokens"][:, 1:].long()
        mask = _target_mask(batch, tgt)
        return ((pred == tgt) * mask).sum() / mask.sum().clamp_min(1.0)
    acc.working_bytes = lambda batch: lm_eval_bytes(cfg, batch)
    return acc
