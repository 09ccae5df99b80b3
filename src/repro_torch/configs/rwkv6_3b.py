"""rwkv6-3b — "Finch": attention-free RNN with data-dependent decay.

[arXiv:2404.05892] RWKV-6 3B: 32 layers, d_model=2560, d_ff=8960,
vocab=65536.  Time-mix (matrix-valued state, per-channel data-dependent
decay via low-rank token-shift mixers) + channel-mix.  O(1) decode state →
the canonical ``long_500k`` architecture.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "rwkv6-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        source="arXiv:2404.05892 (RWKV-6 Finch 3B)",
        n_layers=32,
        d_model=2560,
        n_heads=40,              # heads = d_model / rwkv_head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64,
        norm_kind="layernorm",
        max_seq_len=1_048_576,   # state is O(1) in sequence length
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(n_nodes=16, microbatch=2, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=128, d_ff=256, vocab_size=128,
        n_heads=4, n_kv_heads=4, rwkv_head_dim=32, norm_kind="layernorm",
        dtype="float32", param_dtype="float32",
    )
