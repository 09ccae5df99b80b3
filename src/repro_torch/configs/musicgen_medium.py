"""musicgen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284] MusicGen (Copet et al., 2023), medium size:
48 layers, d_model=1536, 24 heads (GQA kv=24 ⇒ full MHA), d_ff=6144,
vocab=2048 (EnCodec codebook).  The EnCodec conv codec + text conditioner is
the modality frontend — STUBBED per the assignment: ``input_specs`` provides
precomputed frame embeddings; the decoder transformer here is real.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        source="arXiv:2306.05284 (MusicGen medium)",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        mlp_kind="gelu",          # MusicGen uses standard GELU FFN
        norm_kind="layernorm",
        rope_theta=10000.0,
        frontend="audio",
        frontend_dim=128,         # EnCodec latent frame dim (stub)
        max_seq_len=524_288,
    )


def parallel() -> ParallelConfig:
    # ~0.86B trunk params → 16 gossip nodes/pod, pure TP within node.
    return ParallelConfig(n_nodes=16, microbatch=2, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=128, mlp_kind="gelu", norm_kind="layernorm",
        frontend="audio", frontend_dim=32,
        dtype="float32", param_dtype="float32",
    )
