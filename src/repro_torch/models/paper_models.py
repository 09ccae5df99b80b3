"""The paper's model zoo, Table 1 (port of ``repro/models/paper_models.py``).

* 3-layer feed-forward net — MNIST / FMNIST;
* VGG-16 — CIFAR10 / CIFAR100.

GPT-2-small (``gpt2_tinymem_config``, ``lm_*``) waits for a later slice
(ROADMAP Queue 1).  Parameters are nested dicts/lists of tensors in the
reference's layouts — dense ``w`` is ``(in, out)``, conv ``w`` is HWIO and
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

from repro_torch.models.layers import dense_init

__all__ = [
    "ffn_init", "ffn_apply",
    "vgg_init", "vgg_apply",
    "classifier_loss", "classifier_accuracy",
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
