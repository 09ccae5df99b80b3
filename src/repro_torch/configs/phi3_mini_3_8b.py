"""phi3-mini-3.8b — dense decoder, RoPE + SwiGLU.

[arXiv:2404.14219] Phi-3-mini: 32 layers, d_model=3072, 32 heads
(GQA kv=32 ⇒ MHA), d_ff=8192, vocab=32064.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2404.14219 (Phi-3-mini 3.8B)",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=10000.0,
        max_seq_len=131_072,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(n_nodes=16, microbatch=4, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=256, mlp_kind="swiglu",
        dtype="float32", param_dtype="float32",
    )
