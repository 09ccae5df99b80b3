"""Architecture registry: ``--arch <id>`` → (ModelConfig, ParallelConfig).

All 10 assigned architectures plus the paper's own models.  Import is lazy
so ``repro_torch.configs`` stays cheap to import.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ParallelConfig, SHAPES

__all__ = ["ARCHS", "get_config", "get_smoke_config", "get_parallel", "SHAPES"]

ARCHS = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_parallel(arch: str) -> ParallelConfig:
    return _module(arch).parallel()
