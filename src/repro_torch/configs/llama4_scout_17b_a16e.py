"""llama4-scout-17b-a16e — MoE decoder, 16 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E]: 48 layers, d_model=5120, 40 heads
(GQA kv=8), d_ff=8192 (per expert), vocab=202048, 16 routed experts top-1
plus one always-on shared expert (≈17B active / ≈109B total).  Early-fusion
multimodal in the release; the assignment exercises the language trunk.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=500000.0,
        qk_norm=True,
        n_experts=16,
        n_shared_experts=1,
        experts_per_token=1,
        moe_d_ff=8192,
        capacity_factor=1.25,
        max_seq_len=131_072,
    )


def parallel() -> ParallelConfig:
    # ≈109B total → one copy per 128 chips: 2 gossip nodes/pod, FSDP=8.
    return ParallelConfig(n_nodes=2, microbatch=8, remat=True,
                          opt_dtype="bfloat16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, n_experts=4, n_shared_experts=1, experts_per_token=1,
        moe_d_ff=256, qk_norm=True,
        dtype="float32", param_dtype="float32",
    )
