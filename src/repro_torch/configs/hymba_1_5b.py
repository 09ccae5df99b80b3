"""hymba-1.5b — hybrid-head architecture: parallel attention + Mamba heads.

[arXiv:2411.13676] Hymba (NVIDIA, 2024): 32 layers, d_model=1600,
25 heads (GQA kv=5), d_ff=5504, vocab=32001, ssm_state=16.  Each layer runs
attention heads and SSM (Mamba) heads *in parallel* on the same input and
fuses their (normalized) outputs — implemented in
``repro.models.transformer`` via ``hybrid_ssm=True`` (outputs averaged; the
paper's learnable per-path β is approximated by the 0.5/0.5 fuse — noted in
DESIGN.md).  Hymba uses sliding-window attention for most layers with a few
global layers; we model the published pattern as local/local/global.
"""
from repro_torch.configs.base import ModelConfig, ParallelConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        source="arXiv:2411.13676 (Hymba-1.5B)",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        mlp_kind="swiglu",
        attn_pattern=("local", "local", "global"),
        window_size=1024,
        hybrid_ssm=True,
        ssm_state_dim=16,
        ssm_expand=2,
        ssm_conv_dim=4,
        max_seq_len=524_288,      # SSM state + mostly-local attn ⇒ long ctx OK
    )


def parallel() -> ParallelConfig:
    return ParallelConfig(n_nodes=16, microbatch=2, remat=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=128, head_dim=32, attn_pattern=("local", "local", "global"),
        window_size=16, hybrid_ssm=True, ssm_state_dim=8, ssm_expand=2,
        dtype="float32", param_dtype="float32",
    )
