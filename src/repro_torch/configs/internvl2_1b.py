"""internvl2-1b — VLM: InternViT vision encoder + 0.9B LM trunk.

[arXiv:2404.16821] InternVL2-1B (Qwen2-0.5B LM trunk): 24 layers,
d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655.  The InternViT
vision encoder + MLP projector is the modality frontend — STUBBED per the
assignment: ``input_specs`` provides precomputed patch embeddings
(frontend_dim=1024, InternViT-300M output width); the LM trunk is real.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "internvl2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        source="arXiv:2404.16821 (InternVL2-1B / Qwen2-0.5B trunk)",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1000000.0,
        frontend="vision",
        frontend_dim=1024,
        max_seq_len=32_768,
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(n_nodes=16, microbatch=1, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=112, n_heads=4, n_kv_heads=2, d_ff=224,
        vocab_size=256, frontend="vision", frontend_dim=64, head_dim=28,
        dtype="float32", param_dtype="float32",
    )
