"""deepseek-v2-236b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434] DeepSeek-V2: 60 layers, d_model=5120, 128 heads,
MLA kv_lora_rank=512 (q_lora_rank=1536), qk_nope=128, qk_rope=64, v=128;
MoE: 2 shared + 160 routed experts, top-6, per-expert d_ff=1536; first
layer dense (d_ff=12288); vocab=102400.  ≈236B total / ≈21B active.

The MLA latent cache (r=512 + rope 64 per token, layer) is ~18× smaller
than full MHA KV — this is what makes ``long_500k`` decode *fit* for a
236B model (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="arXiv:2405.04434 (DeepSeek-V2 236B)",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,            # the dense first layer's FFN width
        vocab_size=102400,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=10000.0,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        experts_per_token=6,
        moe_d_ff=1536,
        capacity_factor=1.25,
        first_k_dense=1,
        max_seq_len=524_288,   # MLA latent cache keeps 500k viable
    )


def parallel() -> ParallelConfig:
    # 236B ⇒ ONE model copy per pod (FSDP 16 × TP 16 = 256 chips);
    # gossip topology lives on the pod axis (hierarchical tier).
    return ParallelConfig(n_nodes=1, microbatch=16, remat=True,
                          opt_dtype="bfloat16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=256, use_mla=True, kv_lora_rank=32, q_lora_rank=48,
        qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        n_experts=4, n_shared_experts=1, experts_per_token=2,
        moe_d_ff=64, first_k_dense=1,
        dtype="float32", param_dtype="float32",
    )
