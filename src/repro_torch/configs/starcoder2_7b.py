"""starcoder2-7b — dense code model, GQA + RoPE.

[arXiv:2402.19173] StarCoder2-7B: 32 layers, d_model=4608, 36 heads
(GQA kv=4), d_ff=18432, vocab=49152.  Non-gated GELU FFN (4×),
sliding-window 4096 in the released model — modeled here with the
local/global alternation it ships with (every layer windowed except the
final; we use alternating local/global to retain long-range paths).
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "starcoder2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2402.19173 (StarCoder2-7B)",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        mlp_kind="gelu",
        norm_kind="layernorm",
        rope_theta=100000.0,
        attn_pattern=("local", "global"),
        window_size=4096,
        max_seq_len=524_288,   # local/global pattern bounds most of the cache
    )


def parallel() -> ParallelConfig:
    # 7.2B → 72 GB params+opt per node copy / 16 TP chips = 4.5 GB/chip.
    return ParallelConfig(n_nodes=16, microbatch=4, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=144, n_heads=4, n_kv_heads=2, d_ff=288,
        vocab_size=256, mlp_kind="gelu", norm_kind="layernorm",
        attn_pattern=("local", "global"), window_size=16, head_dim=36,
        dtype="float32", param_dtype="float32",
    )
