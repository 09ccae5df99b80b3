"""Roofline analysis on the H100 (port of ``benchmarks/roofline.py``).

Three terms per (arch × shape × mesh), in seconds per step, a device:

  t_compute    = FLOPs_device / 989e12     (bf16 tensor cores, dense)
  t_memory     = HBM_bytes_device / 3.35e12
  t_collective = link_bytes_device / 50e9  (InfiniBand NDR, a GPU)

The FLOP, byte and collective formulas are the reference's, term for term
(``tests/test_torch_roofline.py`` holds every term but the times equal to
its); only the constants are the H100's.  They are **datasheet figures**
(NVIDIA H100 SXM5 80 GB), not measurements: 989 TFLOP/s bf16 dense,
3.35 TB/s HBM3, 80 GB of HBM, 450 GB/s of NVLink a direction inside an
8-GPU node and 400 Gb/s (50 GB/s) of InfiniBand NDR a GPU across nodes.

**The mesh on 8-GPU nodes.**  The reference's pod is a 16 × 16 (data ×
model) mesh, 256 devices, laid out as ``(pod, node, fsdp, model)`` with
``model`` innermost.  On H100 nodes that is 32 nodes of 8 GPUs: ``model``
(16) spans two nodes, its inner factor of 8 on NVLink and its outer
factor of 2 over InfiniBand; ``node`` and ``fsdp`` (the data axis, 16)
and ``pod`` cross InfiniBand.  Every collective axis therefore has an
InfiniBand hop, and a ring over it runs at the slowest link's rate, so
``t_collective`` uses the InfiniBand rate; ``NVLINK_BW`` is kept for a
mapping whose tensor-parallel axis fits one node (tp ≤ 8).

Every number here is modeled, from the formulas; the dry-run
(``launch/dryrun.py``) runs the port's real step on fake tensors to count
FLOPs and bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig, ParallelConfig, SHAPES
from repro_torch.configs.registry import ARCHS, get_config, get_parallel
from repro_torch.launch.specs import LONG_CTX_SKIP

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW", "ICI_BW",
           "HBM_PER_CHIP", "Plan", "resolve_plan", "attention_flops",
           "step_flops", "step_hbm_bytes", "cache_bytes",
           "step_collective_bytes", "hbm_resident_bytes", "analyze_pair",
           "full_table", "format_table"]

# NVIDIA H100 SXM5 80 GB datasheet figures (not measured)
PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s a direction, inside an 8-GPU node
IB_BW = 50e9                 # bytes/s a GPU, 400 Gb/s InfiniBand NDR
ICI_BW = IB_BW               # the rate t_collective uses (module docstring)
HBM_PER_CHIP = 80 * 10**9    # bytes

POD_DATA, POD_MODEL = 16, 16


@dataclasses.dataclass
class Plan:
    """Resolved parallel plan for one pair (mirrors launch/specs.py)."""
    n_global: int          # gossip nodes across the job
    fsdp: int
    model: int = POD_MODEL
    pods: int = 1
    micro: int = 1
    local_batch: int = 0   # sequences per node (train/prefill) or per-node decode batch

    @property
    def chips(self) -> int:
        return self.pods * POD_DATA * POD_MODEL

    @property
    def mb(self) -> int:   # sequences per microbatch per node
        return max(1, self.local_batch // self.micro)


def resolve_plan(cfg: ModelConfig, pcfg: ParallelConfig, shape: InputShape,
                 multi_pod: bool) -> Plan:
    pods = 2 if multi_pod else 1
    n_global = pods * pcfg.n_nodes
    fsdp, tp = pcfg.fsdp, pcfg.tp_degree
    if shape.kind == "train":
        local = shape.global_batch // n_global
        micro = max(1, min(pcfg.microbatch, local))
        while micro > 1 and (local % micro or (local // micro) % fsdp):
            micro -= 1
        return Plan(n_global, fsdp, tp, pods, micro, local)
    if shape.name == "long_500k":
        return Plan(1, fsdp, tp, pods, 1, 1)
    local = max(1, shape.global_batch // n_global)
    return Plan(n_global, fsdp, tp, pods, 1, local)


# ----------------------------------------------------------------------
# FLOPs
# ----------------------------------------------------------------------
def _attn_ctx(seq: int, window: int) -> float:
    """Mean attended context per query under causal (+optional window)."""
    full = (seq + 1) / 2
    return min(full, window) if window > 0 else full


def attention_flops(cfg: ModelConfig, batch: int, seq: int,
                    decode_ctx: Optional[int] = None) -> float:
    """Softmax-attention core FLOPs (QKᵀ + PV), forward, all layers."""
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        h = cfg.d_model // hd
        # state update (outer product + decay) + readout per step per head:
        per_tok = h * hd * hd * 6
        return cfg.n_layers * batch * seq * per_tok
    total = 0.0
    kinds = cfg.layer_kinds()
    for k in kinds:
        w = cfg.window_size if k == "local" else 0
        ctx = _attn_ctx(seq, w) if decode_ctx is None else (
            min(decode_ctx, w) if w else decode_ctx)
        if cfg.use_mla:
            r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
            per = 2 * cfg.n_heads * ctx * (r + dr) + 2 * cfg.n_heads * ctx * r
        else:
            per = 4 * cfg.n_heads * ctx * cfg.head_dim_
        total += batch * seq * per
        if cfg.hybrid_ssm:
            di = cfg.ssm_expand * cfg.d_model
            total += batch * seq * di * cfg.ssm_state_dim * 6
    return total


def step_flops(cfg: ModelConfig, shape: InputShape, plan: Plan) -> Dict[str, float]:
    """Global FLOPs per step (train: fwd+bwd; prefill/decode: fwd)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        matmul = 6 * n_active * tokens
        attn = 3 * attention_flops(cfg, shape.global_batch, shape.seq_len)
        gossip = 2 * plan.n_global ** 2 * cfg.param_count()
        total = matmul + attn + gossip
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        matmul = 2 * n_active * tokens
        attn = attention_flops(cfg, shape.global_batch, shape.seq_len)
        total = matmul + attn
    else:  # decode: ONE token per sequence
        tokens = shape.global_batch
        matmul = 2 * n_active * tokens
        attn = attention_flops(cfg, shape.global_batch, 1,
                               decode_ctx=shape.seq_len)
        total = matmul + attn
    return dict(total=total, per_chip=total / plan.chips,
                model_flops=(6 if shape.kind == "train" else 2) * n_active * (
                    shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)))


# ----------------------------------------------------------------------
# HBM bytes
# ----------------------------------------------------------------------
def step_hbm_bytes(cfg: ModelConfig, pcfg: ParallelConfig, shape: InputShape,
                   plan: Plan) -> Dict[str, float]:
    """Per-device HBM traffic per step (the reference's estimator).

    Weights: each microbatch streams W twice (fwd + bwd reads, bf16) and
    accumulates an f32 grad (rw); the optimizer pass reads g, rw the two
    moments, rw the param.  Per replica the weight shard is P/(fsdp·model)
    params.  Decode/prefill: single bf16 read per step.
    Activations: per layer boundary tensor (mb·S·d bf16) written in fwd,
    re-read + recomputed in bwd (remat ⇒ ×3 traffic factor).
    Logits: mb·S·V f32 fwd+bwd (or streamed — same bytes — for chunked CE).
    KV cache (decode): full cache read per token + one slot write.
    """
    p_total = cfg.param_count()
    p_active = cfg.active_param_count()
    shard = plan.fsdp * plan.model
    p_chip = p_total / shard          # weight params resident per chip
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    s = shape.seq_len

    opt_bytes = 4 if pcfg.opt_dtype == "float32" else 2

    if shape.kind == "train":
        m = plan.micro
        w = p_chip * (m * (2 + 2)          # fwd + bwd bf16 reads per micro
                      + m * 8              # f32 grad accumulator rw
                      + 4 + 2 * 2 * opt_bytes + 4 + 2)   # opt pass
        mb_tokens = plan.mb * s / plan.fsdp / 1.0   # per-chip share of batch
        act = 3 * 2 * L * mb_tokens * d * m          # residual stream traffic
        logits = 8 * mb_tokens * (v / plan.model) * m
        gossip = 2 * p_chip * 2 * plan.n_global      # all-gather read+write f32-ish
        total = w + act + logits + gossip
    elif shape.kind == "prefill":
        tokens_chip = plan.local_batch * s / plan.fsdp
        w = 2 * p_chip
        act = 2 * 2 * L * tokens_chip * d
        total = w + act
    else:
        # decode: weight streaming + cache read.  For MoE the bytes are the
        # *touched* expert set per step: with T tokens per replica routing
        # top-k, E[experts touched] ≈ E·(1 − (1−k/E)^T) — at small per-
        # replica batch only a few experts stream; at large batch all do.
        if cfg.is_moe:
            t_rep = max(1, plan.local_batch)
            e, k = cfg.n_experts, cfg.experts_per_token
            touched = e * (1.0 - (1.0 - k / e) ** t_rep)
            gates = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            fe = cfg.moe_d_ff_
            expert_p = (cfg.n_layers - cfg.first_k_dense) * gates * d * fe
            dense_p = p_total - cfg.n_experts * expert_p
            streamed = dense_p + touched * expert_p
            w = 2 * streamed / shard
        else:
            w = 2 * (p_active / shard)
        cache = cache_bytes(cfg, shape, plan)["per_chip"]
        total = w + cache
    return dict(per_chip=total)


def cache_bytes(cfg: ModelConfig, shape: InputShape, plan: Plan) -> Dict[str, float]:
    """KV/state cache size (resident + read per decode step)."""
    b = shape.global_batch
    t = shape.seq_len
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        h = cfg.d_model // hd
        total = cfg.n_layers * b * (h * hd * hd * 4 + 2 * cfg.d_model * 2)
    elif cfg.use_mla:
        total = cfg.n_layers * b * t * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    else:
        kinds = cfg.layer_kinds()
        per_layer = 0
        for k in kinds:
            tl = min(t, cfg.window_size) if k == "local" else t
            per_layer += 2 * tl * cfg.n_kv_heads * cfg.head_dim_ * 2
        total = b * per_layer
        if cfg.hybrid_ssm:
            di = cfg.ssm_expand * cfg.d_model
            total += cfg.n_layers * b * (di * cfg.ssm_state_dim * 4 +
                                         (cfg.ssm_conv_dim - 1) * di * 2)
    return dict(total=total, per_chip=total / plan.chips)


# ----------------------------------------------------------------------
# collective bytes
# ----------------------------------------------------------------------
def step_collective_bytes(cfg: ModelConfig, pcfg: ParallelConfig,
                          shape: InputShape, plan: Plan,
                          gossip_schedule: str = "dense") -> Dict[str, float]:
    """Per-device collective bytes per step (the reference's model).

    TP: 2 all-reduces (attn-out, mlp-out) per layer per microbatch of the
        residual (mb·S·d bf16); ring all-reduce moves 2·(m-1)/m · msg.
    FSDP: per-layer weight all-gather fwd+bwd ((f-1)/f · W_layer) + grad
        reduce-scatter.
    MoE: 2 all-to-alls per layer of the routed tokens ((E-1)/E ≈ 1).
    Gossip: dense = all-gather of the per-chip param shard across the
        node axis ((N-1) · P_chip); sparse = #offsets · P_chip.
    """
    steps_per_round = max(1, pcfg.steps_per_round)
    p_total = cfg.param_count()
    shard = plan.fsdp * plan.model
    p_chip = p_total / shard
    d, L = cfg.d_model, cfg.n_layers
    s = shape.seq_len if shape.kind != "decode" else 1
    mdl, f, n = plan.model, plan.fsdp, plan.n_global

    if shape.kind == "train":
        m = plan.micro
        toks_chip = plan.mb * s / plan.fsdp
        fwd_bwd = 2  # fwd + bwd each all-reduce
        tp = fwd_bwd * 2 * L * m * toks_chip * d * 2 * (2 * (mdl - 1) / mdl)
        fsdp_b = (2 * m * p_chip * 2 * (f - 1)) + (p_chip * 4 * (f - 1) / f)
        moe = 0.0
        if cfg.is_moe:
            k_eff = (min(cfg.experts_per_token, pcfg.moe_group_limit)
                     if pcfg.moe_group_limit else cfg.experts_per_token)
            routed = toks_chip * k_eff * d * 2
            moe = 2 * 2 * (L - cfg.first_k_dense) * m * routed
        if gossip_schedule == "dense":
            gossip = (n - 1) * p_chip * 2 / steps_per_round
        else:
            from repro_torch.core.mixing import circulant_decomposition
            from repro_torch.core.strategies import (AggregationStrategy,
                                                     mixing_matrix)
            from repro_torch.core.topology import barabasi_albert
            topo = barabasi_albert(max(n, 3), min(2, max(n - 1, 1)), seed=0) \
                if n > 2 else None
            if topo is None:
                gossip = (n - 1) * p_chip * 2
            else:
                c = mixing_matrix(topo, AggregationStrategy("degree", tau=0.1))
                sched = circulant_decomposition(c)
                nonzero = sum(1 for o in sched.offsets if o != 0)
                gossip = nonzero * p_chip * 2 / steps_per_round
        pod = 0.0
        if plan.pods > 1:
            pod = p_chip * 2  # inter-pod exchange of the shard
        total = tp + fsdp_b + moe + gossip + pod
        parts = dict(tp=tp, fsdp=fsdp_b, moe=moe, gossip=gossip, pod=pod)
    elif shape.kind == "prefill":
        toks_chip = plan.local_batch * s / plan.fsdp
        tp = 2 * L * toks_chip * d * 2 * (2 * (mdl - 1) / mdl)
        # weights are 2-D sharded and consumed sharded in fwd-only steps;
        # the fsdp axis instead costs one activation reduce per layer.
        fsdp_b = (2 * L * toks_chip * d * 2 * (f - 1) / f) if f > 1 else 0.0
        moe = 0.0
        if cfg.is_moe:
            moe = 2 * (L - cfg.first_k_dense) * toks_chip * \
                cfg.experts_per_token * d * 2
        total = tp + fsdp_b + moe
        parts = dict(tp=tp, fsdp=fsdp_b, moe=moe)
    else:
        toks_chip = max(1.0, plan.local_batch / max(plan.fsdp, 1))
        tp = 2 * L * toks_chip * d * 2 * (2 * (mdl - 1) / mdl)
        fsdp_b = (2 * L * toks_chip * d * 2 * (f - 1) / f) if f > 1 else 0.0
        moe = 0.0
        if cfg.is_moe:
            moe = 2 * (L - cfg.first_k_dense) * toks_chip * \
                cfg.experts_per_token * d * 2
        total = tp + fsdp_b + moe
        parts = dict(tp=tp, fsdp=fsdp_b, moe=moe)
    return dict(per_chip=total, parts=parts)


# ----------------------------------------------------------------------
# HBM fit
# ----------------------------------------------------------------------
def hbm_resident_bytes(cfg: ModelConfig, pcfg: ParallelConfig,
                       shape: InputShape, plan: Plan) -> Dict[str, float]:
    p_total = cfg.param_count()
    shard = plan.fsdp * plan.model
    opt_bytes = 8 if pcfg.opt_dtype == "float32" else 4
    per_chip = p_total / shard * 2          # bf16 weights
    if shape.kind == "train":
        per_chip += p_total / shard * (opt_bytes + 4)   # moments + f32 grad acc
        act = 2 * cfg.n_layers * plan.mb * shape.seq_len * cfg.d_model / plan.fsdp
        per_chip += act
    if shape.kind == "decode":
        per_chip += cache_bytes(cfg, shape, plan)["per_chip"]
    return dict(per_chip=per_chip, fits=per_chip < HBM_PER_CHIP * 0.9)


# ----------------------------------------------------------------------
# full report
# ----------------------------------------------------------------------
def analyze_pair(arch: str, shape_name: str, multi_pod: bool = False,
                 gossip_schedule: Optional[str] = None,
                 cfg: Optional[ModelConfig] = None,
                 pcfg: Optional[ParallelConfig] = None) -> Dict:
    cfg = cfg or get_config(arch)
    pcfg = pcfg or get_parallel(arch)
    shape = SHAPES[shape_name]
    plan = resolve_plan(cfg, pcfg, shape, multi_pod)
    sched = gossip_schedule or pcfg.gossip_schedule

    fl = step_flops(cfg, shape, plan)
    hbm = step_hbm_bytes(cfg, pcfg, shape, plan)
    coll = step_collective_bytes(cfg, pcfg, shape, plan, sched)
    fit = hbm_resident_bytes(cfg, pcfg, shape, plan)

    t_c = fl["per_chip"] / PEAK_FLOPS
    t_m = hbm["per_chip"] / HBM_BW
    t_x = coll["per_chip"] / ICI_BW
    dominant = max([("compute", t_c), ("memory", t_m), ("collective", t_x)],
                   key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_x)
    return dict(
        arch=arch, shape=shape_name,
        mesh="2x16x16" if multi_pod else "16x16",
        kind=shape.kind, n_nodes=plan.n_global, fsdp=plan.fsdp,
        micro=plan.micro, gossip=sched,
        t_compute_s=t_c, t_memory_s=t_m, t_collective_s=t_x,
        dominant=dominant,
        roofline_frac=t_c / bound if bound else 0.0,  # compute fraction of bound
        model_flops=fl["model_flops"],
        hlo_flops_global=fl["total"],
        useful_flops_ratio=fl["model_flops"] / fl["total"],
        collective_parts=coll["parts"],
        hbm_resident_per_chip=fit["per_chip"], fits_hbm=fit["fits"],
        modeled=True,
    )


def full_table(multi_pod: bool = False):
    rows = []
    for arch in ARCHS:
        for name in SHAPES:
            if name == "long_500k" and arch in LONG_CTX_SKIP:
                rows.append(dict(arch=arch, shape=name,
                                 skipped=LONG_CTX_SKIP[arch]))
                continue
            rows.append(analyze_pair(arch, name, multi_pod))
    return rows


def format_table(rows) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'nodes':>5s} {'t_comp':>9s} "
           f"{'t_mem':>9s} {'t_coll':>9s} {'dom':>10s} {'useful':>7s} "
           f"{'HBM/dev':>9s} {'fits':>5s}")
    lines = ["modeled: H100 SXM5 datasheet constants (989 TFLOP/s bf16, "
             "3.35 TB/s HBM, 80 GB, 50 GB/s InfiniBand a GPU), not measured",
             hdr, "-" * len(hdr)]
    for r in rows:
        if "skipped" in r:
            lines.append(f"{r['arch']:24s} {r['shape']:12s}  SKIP: {r['skipped']}")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['n_nodes']:5d} "
            f"{r['t_compute_s']:9.2e} {r['t_memory_s']:9.2e} "
            f"{r['t_collective_s']:9.2e} {r['dominant']:>10s} "
            f"{r['useful_flops_ratio']:7.2f} "
            f"{r['hbm_resident_per_chip']/1e9:8.2f}G "
            f"{'yes' if r['fits_hbm'] else 'NO':>5s}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--out", default="artifacts_torch")
    args = ap.parse_args(argv)
    rows = full_table(multi_pod=args.multipod)
    print(format_table(rows))
    tag = "2pod" if args.multipod else "1pod"
    out = os.path.join(args.out, f"roofline_{tag}.json")
    os.makedirs(args.out, exist_ok=True)
    with open(out, "w") as fh:
        json.dump(rows, fh, indent=1, default=float)
    print(f"\nwritten → {out}")
    return rows


if __name__ == "__main__":
    main()
