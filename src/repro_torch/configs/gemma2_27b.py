"""gemma2-27b — dense decoder with local/global alternation + softcaps.

[arXiv:2408.00118] Gemma-2 27B: 46 layers, d_model=4608, 32 heads
(GQA kv=16), d_ff=36864, vocab=256000, head_dim=128, alternating
sliding-window(4096)/global attention, attention-logit softcap 50,
final-logit softcap 30, RMSNorm, GeGLU.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "gemma2-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2408.00118 (Gemma-2 27B)",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36864,
        vocab_size=256000,
        head_dim=128,
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        rope_theta=10000.0,
        attn_pattern=("local", "global"),
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        max_seq_len=524_288,   # long_500k via the sliding-window variant:
                               # local layers cache 4k; global layers are the
                               # gate — dryrun verifies the fit (DESIGN.md §4)
    )


def parallel() -> ParallelConfig:
    # 27B ⇒ 4 gossip nodes/pod (FSDP 4 × TP 16 = 64 chips per copy).
    return ParallelConfig(n_nodes=4, microbatch=8, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=256, head_dim=32, mlp_kind="geglu",
        attn_pattern=("local", "global"), window_size=16,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        dtype="float32", param_dtype="float32",
    )
