"""Model / run configuration system.

A single frozen :class:`ModelConfig` describes every architecture family in
the zoo (dense, MoE, SSM, hybrid, VLM, audio).  Family-specific fields are
simply unused by other families.  Every assigned-architecture file in
``repro/configs/`` instantiates one of these with the exact values from the
assignment (sources cited in each file) and also provides ``smoke()`` — the
reduced variant (≤2 layers, d_model ≤ 512, ≤4 experts) used by CPU tests.

``ParallelConfig`` carries the distribution plan consumed by
``repro/launch``: how the production mesh's ``data`` axis is split between
the gossip-topology node axis and FSDP, microbatching, remat, etc.  See
DESIGN.md §5 for the memory math that picks ``n_nodes`` per arch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "ParallelConfig", "RunConfig", "SHAPES", "InputShape"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity ----------------------------------------------------------
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""               # citation for the config values

    # trunk -------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None          # default: d_model // n_heads
    mlp_kind: str = "swiglu"                # swiglu | gelu | geglu
    norm_kind: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 8192

    # attention variants --------------------------------------------------
    rope_theta: float = 10000.0
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    window_size: int = 4096                        # for "local" layers
    attn_logit_softcap: float = 0.0                # gemma2: 50.0
    final_logit_softcap: float = 0.0               # gemma2: 30.0
    qk_norm: bool = False

    # MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE -----------------------------------------------------------------
    n_experts: int = 0              # 0 = dense MLP
    n_shared_experts: int = 0
    experts_per_token: int = 1
    moe_d_ff: Optional[int] = None  # per-expert hidden (default d_ff)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    first_k_dense: int = 0          # deepseek: first layer(s) dense

    # SSM / RWKV ----------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2             # mamba d_inner = expand * d_model
    rwkv_head_dim: int = 64

    # hybrid (hymba) ------------------------------------------------------
    hybrid_ssm: bool = False        # parallel attn+SSM heads per layer

    # modality frontend stub ----------------------------------------------
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0           # embedding dim provided by the stub

    # dtypes ----------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # -----------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic decode: SSM/hybrid always; attention archs when a
        sliding-window pattern bounds (most of) the cache, or MLA compresses
        it (checked against HBM in launch/dryrun.py)."""
        return (
            self.family in ("ssm", "hybrid")
            or "local" in self.attn_pattern
            or self.use_mla
        )

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind by cycling ``attn_pattern``."""
        pat = self.attn_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            att = d * (self.n_heads * hd) * 4 + d * (self.n_heads * hd)  # r,k,v,g,o
            att += 6 * d * 32 * 2 + d * hd  # lora mixers + decay (approx)
            mlp = 2 * d * f + f * d  # rwkv channel-mix has k,r,v
        elif self.use_mla:
            att = d * self.kv_lora_rank + d * self.qk_rope_head_dim
            att += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            if self.q_lora_rank:
                att += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim)
            else:
                att += d * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            att += self.n_heads * self.v_head_dim * d
            mlp = 0  # counted via moe below
        else:
            att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            mlp = (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * f
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        if self.is_moe:
            fe = self.moe_d_ff_
            moe = (self.n_experts + self.n_shared_experts) * gates * d * fe + d * self.n_experts
            dense_layers = self.first_k_dense
            moe_layers = self.n_layers - dense_layers
            body = moe_layers * (att + moe) + dense_layers * (att + gates * d * f)
        else:
            body = self.n_layers * (att + mlp)
        if self.hybrid_ssm:
            d_in = self.ssm_expand * d
            body += self.n_layers * (2 * d * d_in + d_in * d + d_in * self.ssm_state_dim * 2)
        return int(emb + body)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        fe = self.moe_d_ff_
        inactive = (
            (self.n_layers - self.first_k_dense)
            * (self.n_experts - self.experts_per_token)
            * gates * self.d_model * fe
        )
        return self.param_count() - int(inactive)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the production mesh's axes are used for this arch (DESIGN.md §5).

    The pod's ``data`` axis (16) is split ``node × fsdp``:
      * ``n_nodes``  — gossip-topology nodes in one pod (paper's devices),
      * ``16 // n_nodes`` — FSDP shards *within* each node's model copy.
    ``model`` (16) is tensor parallel.  Multi-pod adds the ``pod`` axis
    (hierarchical gossip tier).
    """

    n_nodes: int = 16
    tp_degree: int = 16             # tensor-parallel width (model axis)
    microbatch: int = 1             # grad-accumulation chunks per train step
    remat: bool = True              # checkpoint each layer in train fwd
    opt_dtype: str = "float32"      # adam moment dtype ("bfloat16" to halve)
    scan_layers: bool = True
    chunked_ce: int = 0             # >0: sequence-chunked cross-entropy width
    gossip_schedule: str = "dense"  # dense | sparse (circulant ppermute)
    steps_per_round: int = 1        # optimizer steps between gossips (Alg. 1
                                    # rounds amortize the gossip collective)
    moe_group_limit: int = 0        # device-limited routing (DeepSeek-V2
                                    # §2.1.3): token reaches ≤M expert groups

    @property
    def fsdp(self) -> int:
        return 256 // (self.n_nodes * self.tp_degree)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    parallel: ParallelConfig
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    rounds: int = 40
    local_epochs: int = 5
    topology: str = "ba"
    topology_kwargs: tuple = (("p", 2),)
    strategy: str = "degree"
    tau: float = 0.1
    seed: int = 0
