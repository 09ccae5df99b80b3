"""Shared initializers (port of ``dense_init`` from
``repro/models/layers.py``; the transformer blocks wait for a later
slice)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["dense_init"]


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               device=None, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init, layout ``(in, out)``.  Drawn on
    the CPU from ``generator`` (the port's own stream — it does not
    reproduce JAX's numbers), then moved to ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=generator)
    return (t * std).to(dtype=dtype, device=device)
