"""stablelm-1.6b — dense decoder.

[hf:stabilityai/stablelm-2-1_6b]: 24 layers, d_model=2048, 32 heads
(GQA kv=32 ⇒ MHA), d_ff=5632, vocab=100352.  RoPE (partial in the released
model; full here), SiLU-gated MLP, LayerNorm.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        mlp_kind="swiglu",
        norm_kind="layernorm",
        rope_theta=10000.0,
        max_seq_len=32_768,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(n_nodes=16, microbatch=2, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=256, mlp_kind="swiglu", norm_kind="layernorm",
        dtype="float32", param_dtype="float32",
    )
