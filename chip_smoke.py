#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, in order; any failure raises and the script exits nonzero:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
   started together; build seconds printed);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes — the FFN plane (33, 118282) and the VGG-16 plane (33, 14982479),
   f32 and bf16 — with CUDA-event medians beside the byte/FLOP bound, the
   plain version and one library call computing the same function (none
   exists for the robust kernel); the robust kernel for the trimmed mean
   (k = 1) and the median, plus an FFN plane with NaN/±Inf rows, to max
   abs err 0; the legacy K-way MAC ``gossip_mix`` at VGG-16's largest leaf
   (K = R = 33, N = 2,359,296; f32 and bf16), the FFN's first leaf, a
   ragged (5, 513, 129) with R = 1 and a one-value leaf, to max abs err 0
   (bf16: one ulp), ``torch.matmul`` its yardstick.  Beside the dense
   mixes' library call, and for the robust kernel, which has none,
   ``copy_ms`` times one device-to-device copy of the kernel's input bytes
   (the rate a streaming kernel can reach), and ``kernel_model`` lines
   give the arithmetic's modeled issue floor of the dense mixes, the
   robust kernel and the RWKV-6 scan (f32 lanes at the SM clock's
   maximum; not a measurement);
3. Algorithm 1 at the paper's scale with the FFN (the quickstart scenario
   at ``FULL`` scale: BA(33, p=2), OOD on the hub, R = 40): ``unweighted``
   and ``degree`` through the fused-plane kernel, one launch per mix, and
   degree's OOD AUC above unweighted's; then 3 rounds through every mix
   backend, whose per-node accuracies must agree; ``"sparse"`` falls back
   to the einsum on BA(33, 2) (33 ring offsets against a max degree of
   14): no kernel launched and a history equal to einsum's;
4. VGG-16 at full width (P = 14,982,479 per node, n = 33): 2 rounds
   through the fused-plane kernel, 1 through the edge-list kernel and 1
   through the robust kernel (trimmed mean);
6. the robust trainer at the phase-3 scale, cut to
   ``ROBUST_CUT_ROUNDS`` = 20 rounds: ``degree`` with
   ``robust="trimmed"`` through the robust kernel (exactly R launches,
   finite params, IID AUC >= 0.9, OOD AUC beside phase 3's mean run), then
   ``robust="norm_clip"`` through the fused-plane kernel;
7. the fault layer at the same scale, cut to ``FAULT_CUT_ROUNDS`` = 10
   rounds (printed on a ``reduced`` line), through ``make_fault_round_fn``:
   rate 0 bit-identical to ``make_round_fn``; NaN faults contained by the
   quarantine screen (and poisoning the plane without it); sign-flip
   faults under the mean, the median and the trimmed mean;
8. serving, stablelm-1.6b at full width and depth (bf16, 1.64 B
   parameters per node, a fleet of n = 4 in one 13.2 GB plane, a
   distinct init per node drawn on the card): ``FleetScheduler`` serves 2
   requests of 64 tokens per node, 16 new tokens each; one fleet decode
   step is timed at that cache and at a 4096-token one; the
   full-sequence prefill through the flash kernel makes exactly 24
   launches, agrees with the chunked prefill and, to a fixed bound, with
   the decode path, and its argmax is each request's first token wherever
   the top-2 margin exceeds twice that bound; a long prefill (S = 4096
   per node); ``swap_node`` installs a new row that the next request
   decodes with;
9. gemma2-27b at full width cut to its first local and global layer
   (bf16, S = 8192): the flash prefill (exactly 2 launches) against the
   chunked one;
10. serving rwkv6-3b at full width and depth (bf16 with its f32 decay
   leaves, 3.10 B parameters per node, a fleet of n = 2 in one f32 plane,
   a distinct init per node drawn on the card): ``FleetScheduler`` serves
   2 requests of 64 tokens per node, 16 new tokens each; a second wave
   re-uses the freed slots and must equal the same prompts served by a
   fresh ``FleetScheduler``; the full-sequence prefill through the RWKV-6
   scan kernel makes exactly 32 launches and each layer's kernel time-mix
   agrees with the plain scan body on the same input; the same model cut
   to 2 layers (where a random init is not yet chaotic) holds its kernel
   prefill to the plain scan body and to the decode path by fixed bounds,
   and its argmax to each first token wherever the top-2 margin exceeds
   twice the decode bound; a long prefill (S = 4096 per node); one fleet
   decode step at position 81 and at 4088 with the share of its device
   time spent casting the plane; ``swap_node`` installs a new row that the
   next request decodes with;
11. serving deepseek-v2-236b at full width cut to its dense first layer
   (MLA: 128 heads over a rank-512 latent; bf16, 1.39 B parameters per
   node, a fleet of n = 4 in one 11.1 GB plane, a distinct init per node
   drawn on the card): ``FleetScheduler`` serves 2 requests of 64 tokens
   per node, 16 new tokens each; a second wave re-uses the freed slots
   and must equal the same prompts served by a fresh ``FleetScheduler``;
   the full-sequence prefill through the latent-attention kernel makes
   exactly 1 launch and agrees with the plain chunked prefill and, to a
   fixed bound, with the decode path, and its argmax is each first token
   wherever the top-2 margin exceeds twice that bound; a long prefill
   (S = 4096 per node); one fleet decode step at position 81 and at 4088;
   ``swap_node`` installs a new row that the next request decodes with;
12. the mix-cost study (``repro_torch.benchmarks.gossip_cost``, the port
   of ``benchmarks/gossip_cost.py``): ``run_mix`` at the FFN and VGG-16
   trees (n = 33) through every backend, each held to the einsum first,
   the legacy rows mix making exactly one ``gossip_mix`` launch a leaf (6
   and 35); ``run`` (dense against circulant schedules, with the RCM
   relabel) at 8 M floats a node on ring16, BA(16, 1), BA(16, 2) and
   WS(16, 4, 0.5); ``run_scaling`` (fused plane against edge list) at the
   FFN's width for n = 64, 256, 1024; the trainer with
   ``mix_impl="sparse"`` on ring(33), where the schedule holds, for
   ``degree`` and ``metropolis``, within 3 of 512 eval samples per node of
   the fused plane on the same graph;
13. (between 7 and 8) every strategy and link failure at the phase-3
   scale, on the card batches of phases 6-7: Fig. 4's ``fl``,
   ``weighted``, ``random`` and ``betweenness`` through the fused plane
   (exactly R launches each; ``random``'s R matrices row-stochastic on
   adj + I and not all equal), one line with all six OOD AUCs (phase 18
   (a)'s grid holds betweenness above unweighted at R = 40); ``degree``
   at p_fail 0.3, nominal and reactive, its coefficient program's matrices through
   ``coeffs_fn`` and the edge-list kernel (exactly R launches, every
   round row-stochastic with its support inside that round's survivors +
   I, edges dropped), the reactive program 3 rounds through both kernels
   within 3 of 512 eval samples; then Fig. 6's SB(33, 3, 0.5, p_out)
   graphs for p_out 0.009, 0.05, 0.9 (modularity, connected) and, on the
   most modular, ``unweighted`` and ``degree`` with the OOD data on its
   highest-degree node (its own batches on the card); every run takes
   ``PHASE13_CUT_ROUNDS`` = 10 of the 40 rounds (``reduced`` lines):
   the paper's claim at R = 40 is phase 3's (degree) and phase 18 (a)'s
   (all six Fig. 4 strategies);
14. (after 13, its card batches freed) the paper's grids through the
   sweep engine (``repro_torch.core.sweep``) on phase 3's scenario:
   (a) the kernels' experiment axis — ``gossip_plane`` at the FFN plane
   with E = 6 and the VGG-16 plane with E = 2, ``gossip_edges`` and
   ``gossip_robust`` (trimmed, median; NaN/±Inf rows) at the FFN plane
   with E = 3, each one launch equal to E single launches bit for bit,
   timed beside the singles and the byte bound; (b) Fig. 4 at paper
   scale as ONE grid (six strategies, E = 6, through
   ``benchmarks.common.run_sweep_cells`` and one batched ``gossip_plane``
   launch a round): s/round, AUCs, the device syncs the run makes
   (``torch.cuda.set_sync_debug_mode``), peak memory, ``fig4.verdict``,
   each experiment's drift from its phase-3/13 single-trainer run; (c)
   the same grid chunked with a checkpoint at each boundary, resumed from
   its middle one, and unrolled (cut to half the rounds), each bit for
   bit the scanned run; (d) ``ablations.run_link_failure``'s grid (unweighted, degree at
   p_fail 0.3, nominal and reactive, matrices made in the round loop)
   through batched ``gossip_edges``, the nominal program equal to its
   materialized stack bit for bit, degree held by drift to phase 13; (e)
   ``byzantine_cells`` at fault rates 0, 0.1, 0.2 through the batched
   trimmed mean, ``"noise"`` faults with the quarantine screen and a
   ``"nan"`` group with ``skip_nonfinite_updates(sgd)``, the rate-0
   experiment held by drift to phase 6's trimmed run; (b) and (c) run
   ``FIG4_GRID_ROUNDS`` = 24 and (d), (e) ``SWEEP_CUT_ROUNDS`` = 10 of
   FULL's 40 rounds, held by drift on the single runs' first rounds
   (printed on ``reduced`` lines; Fig. 4's grid at R = 40 is phase 18
   (a)'s);
15. (after 14) GPT-2 on TinyMem, the paper's third model (GPT-2-small
   cut to one layer, Table 1: d 768, 12 heads, d_ff 3072, f32, P =
   7,107,072 a node), on BA(33, 2) with the language backdoor on the
   hub, FULL scale's data: ``gossip_plane`` at the GPT-2 plane, (33, P)
   and batched at E = 2, within 1e-5·max|ref| of its plain version, timed
   beside its bound, ``torch.matmul`` and ``copy_``; (a) two rounds of
   ``DecentralizedTrainer`` (``degree``, the fused plane, 5 local epochs
   of the median node's steps): s/round, peak memory, finite losses, the
   second round's mean loss below the first's; (b) Fig. 4's pair
   (``unweighted``, ``degree``) as one sweep-engine grid (E = 2, the bank
   on the card, one batched launch a round), cut to 2 rounds of one
   local epoch: s/round, no sync in the round loop, per-round IID and OOD
   accuracy, each experiment held by drift to a single-trainer run of the
   same cell and cut; (c) ``make_train_step`` at n = 8, microbatch 2,
   ``make_optimizer("adamw", warmup_cosine_schedule(...))`` behind the
   nonfinite guard, batches from ``lm_token_stream``, gossip on: finite
   losses.  Every cut is printed on a ``reduced`` line;
16. (after 12) serving the MoE block at full width, n = 2 nodes in one
   f32 plane (the router is f32), each node's init drawn on the card and
   written into its row: deepseek-v2-236b cut to 2 layers (its dense
   first layer and one MoE layer: MLA, 160 experts top-6 + 2 shared;
   5,358,679,040 parameters in 35 leaves a node) and llama4-scout-
   17b-a16e cut to 1 MoE layer (GQA 40/8 with ``qk_norm``, 16 experts
   top-1 + 1 shared; 4,271,078,656 in 18).  At the published capacity
   factor 1.25: a served wave, each first token the decode path's argmax;
   the kernel prefill (one ``mla_tc_kernel`` or ``flash_tc_kernel``
   launch a layer for the fleet) against the plain chunked prefill, the
   share of routing flips bounded and the logits bounded where a
   sequence's own routing agrees; ``swap_node``.  At a dropless factor
   (E / k, cap = t) the kernel prefill against the decode path, before
   and after the swap.  deepseek-v2 adds a second wave into re-used
   slots against a fresh scheduler, a 2 × 4096 prefill (the attention
   kernel's share from ``torch.profiler``), a decode step at position 81
   with the unpack casts' share, the MoE block's parts (router,
   dispatch, experts, combine, shared) at both, the expert products'
   TFLOP/s, the dropped-pair shares and peak memory; its own 180 s
   budget;
17. (after 16) the rest of the zoo, its own 180 s budget
   (``HYBRID_BUDGET_S``): hymba-1.5b at full size (32 layers, d 1600,
   GQA 25/5, hd 64, windows 1024 local/local/global, Mamba heads beside
   attention: ``ssm_state_dim`` 16, expand 2, conv 4; bf16 with three f32
   leaf kinds, 1,641,681,600 parameters a node), n = 4 in one 26.3 GB f32
   plane: a warm-up wave, a second wave into the used slots equal token
   for token to the same prompts on a fresh ``FleetScheduler`` (a
   re-used slot's Mamba state zeroed) (the served rate is the median of
   those two timed waves); per layer, the flash attention
   against einsum attention on the same input (relative error, gated);
   the full-depth kernel prefill against the decode path by a fixed
   bound, and each first token against both argmaxes; the model cut to
   2 layers, the same gate there and ``greedy_generate`` at temperature
   0.8 (one key
   twice gives one sample, a second key is logged); a 4 × 4096 prefill
   through the flash kernel (one launch a layer) with the Mamba scans'
   share of the wall time, and the device time of its layers, flash's
   and the Mamba loop's (``torch.profiler`` over one local and one
   global layer, times their counts); a decode step at positions 81 and 4088
   with the unpack casts' share; the serve CLI on the 2-layer cut; then
   internvl2-1b (24 layers, d 896, 14/2) and musicgen-medium (48 layers,
   d 1536, 24/24) at full size: a (2, 4096) prefill from seeded stub
   frontend embeddings through flash against the chunked one, and
   internvl2-1b's ``make_train_step`` at n = 2 (n = 4 does not fit the
   card's memory in eager AdamW), microbatch 1, S = 512, 3 AdamW steps
   behind the nonfinite guard, gossiping by BA(2, 1)'s degree matrix
   through the fused-plane kernel (one launch a step): finite losses,
   none skipped;
18. (after 17) the entry points, its own 120 s budget
   (``ENTRY_BUDGET_S``): (a) the sweep CLI (``python -m
   repro_torch.benchmarks.sweep``): ``--list``, fig4's ``--full
   --dry-run`` plan, fig4 ``--full`` at one seed (six strategies, n = 33,
   R = 40, the paper's claim), ``edges`` at the smoke scale on BA(64, 2)
   through ``edges_kernel`` (one launch a round) and fig4 ``--smoke``,
   each with the legacy baseline (one ``run_experiment`` a cell: the
   trainer's per-round loop; ``edges`` one launch a cell a round) held to
   the grid by a measured drift bound; (b) the fleet serving benchmark at
   stablelm-1.6b's full width and depth in f32, fleets of 2 and 4, 2
   slots a node: tok/s,
   p50/p95/p99 latency and slot occupancy of the fleet step and the
   per-node loop, outputs identical, the swap check; (c) phi3-mini-3.8b
   at full size (hd 96; 3,821,079,552 parameters a node) through the
   serve CLI, n = 4 in one 30.6 GB bf16 plane, then a (4, 4096) prefill
   through the flash kernel's hd-96 instantiation held to the chunked
   prefill; (d) starcoder2-7b the same way (hd 128, GQA 36/4, windows of
   4096 alternating local and global; 7,399,351,296 parameters), n = 2
   (29.6 GB), a (2, 4096) prefill; (e) the train driver (``python -m
   repro_torch.launch.train``) on internvl2-1b at full size through its
   text embedding, n = 2, 2 rounds of 2 steps at S = 512, each round's
   gossip one ``gossip_plane`` launch, and the smoke config's
   ``--ckpt-dir``/``--resume`` round trip equal bit for bit to the
   uninterrupted run.  Every cut is printed on a ``reduced`` line;
19. (after 18) the multi-device paths, its own 60 s budget
   (``MULTI_BUDGET_S``): (a) ``core.gossip`` on an NCCL group of this
   process (a world of 1, on a ``reduced`` line: NCCL refuses two ranks
   on one card):
   ``make_gossip_fn``'s dense mix at the FFN and VGG-16 planes (BA(33, 2)
   ``degree``), exactly one all-gather and one ``gossip_mix`` launch a
   mix, held to ``gossip_plane`` on the same plane and timed beside it
   and the byte bound, the launch alone against its plain version; the
   circulant ``gossip_sparse`` on ring(33) against ``mix_sparse_host``;
   (b) the sweep CLI under ``python -m torch.distributed.run
   --nproc-per-node 2`` (``chip_smoke.py --sweep-rank``, which runs the
   CLI's ``main`` and prints the rank's ``gossip_edges`` launches) with
   phase 18 (a)'s ``edges`` arguments and ``--shard 2``: both ranks on
   the card, one experiment and one ``edges_kernel`` launch a round
   each, the kernels phase 1 built; its rows against phase 18 (a)'s,
   its ``sharded/edges`` record, and the same with ``--chunk-rounds 2``
   bit for bit;
20. (after 19) the tooling, its own 45 s budget (``TOOLING_BUDGET_S``):
   (a) ``repro_torch.analysis``'s ``engine-matrix`` preset (49 combos of
   the sweep engine's step through ``SweepEngine.traceable``; the mesh
   combos over a sweep mesh of this rank alone, on a ``reduced`` line)
   and its ``serve`` preset on the card, every report clean, every kernel
   wrapper's ``calls`` equal to its ``launches``, the rounds under
   ``set_sync_debug_mode("error")``; (b) the memory dry-run
   (``repro_torch.launch.dryrun``, computed in a process of its own from
   the start of phase 2: it needs no device) beside the card's
   ``max_memory_allocated`` over phase 17's internvl2-1b train step and
   phase 8's long fleet decode step, each less the bytes allocated just
   before the step's inputs were built (against the prediction less what
   the dry-run counts as already resident there: phase 8's plane), each
   ratio within its pinned bound (``PEAK_RATIO_BOUNDS``), its verdict that the train step at n = 4 does
   not fit, and its 80 GB constant against the card's total memory; (c)
   the roofline table of every arch × shape pair (modeled, the H100's
   datasheet constants);
21. (after 20) the examples, its own 60 s budget (``EXAMPLES_BUDGET_S``),
   each as written (``repro_torch.examples``): (a) quickstart (BA(16, 2),
   25 rounds, einsum: no launch; degree's OOD AUC above unweighted's); (b)
   the LLM pre-training example at ``--full100m`` with its defaults (n =
   4, 25 rounds of 8 AdamW steps, f32): finite losses, the last round's
   mean below the first's, exactly one ``gossip_plane`` launch a round at
   (4, 65,020,416) f32, s/round and the peak memory, and the kernel at
   that shape against its plain version; (c) the two-pod example for both
   bridges (one inter-pod edge; the hub bridge above the leaf one); (d)
   per-node serving (logits (8, 4, 1, 16), a node's row against
   ``decode_step`` of its params); (e) ``attention_apply`` with and
   without flash at smoke shapes (one flash launch a call, the phase-2 f32
   gate); (f) ``perf_iterations``' four modeled speedups;
22. (after 21) the legacy per-round loop, its own 120 s budget
   (``LEGACY_BUDGET_S``): (a) ``common.run_experiment`` on Fig. 4's
   degree cell at full scale (BA(33, 2), FULL, ``mix_impl="pallas"``):
   exactly 40 ``gossip_plane`` launches at (33, 118,282) f32, s/round of
   the host loop, its per-node accuracies held to phase 18 (a)'s fig4
   ``--full`` degree history (the same cell through the engine) by a
   measured drift bound; (b) ``ablations.run_link_failure(in_scan=False)``
   at 10 rounds through the fused plane against ``in_scan=True`` on the
   same cells: equal AUCs, 0 samples apart, the reference's claim;
5. the per-round time breakdowns (FFN, VGG-16, GPT-2-TinyMem), the kernel
   JSON line, the card line and the device line (last).

Phase 2 also holds the flash-attention kernels (bf16 on the tensor cores,
f32 on the CUDA cores) against their plain version
at the stablelm prefill shape (4, 4096, 32 heads, hd 64; bf16 and f32),
the gemma2 shapes (1, 8192, 32 over 16 kv heads, hd 128, cap 50, window
4096 and 0) and a ragged S, with SDPA as the library yardstick where no
softcap applies (causal, or with the window as a boolean mask) and
``flex_attention`` (compiled) where one
does.  It also holds the RWKV-6 scan kernel against its plain version
at the rwkv6-3b prefill shape (2, 4096, 40 heads, hd 64; bf16 from a zero
and a nonzero state, f32), a ragged (3, 1000, 4, 64) whose r, k, v are
slices of one fused tensor, and hd 32; no PyTorch call computes the
recurrence, so it has no library yardstick.  The flash cases also take
phase 17's shapes: hymba-1.5b's (4, 4096, 25 over 5 kv heads, hd 64)
with a window of 1024 and without, internvl2-1b's (2, 4096, 14 over 2)
and musicgen-medium's (2, 4096, 24 over 24), and phase 18's hd 96:
phi3-mini-3.8b's (4, 4096, 32 over 32) and a ragged (3, 1000, 8 over 2),
f32 and bf16.  And it holds the MLA
latent-attention kernels against their plain version at deepseek-v2's
prefill shape (4, 4096, 128 heads, r 512, dr 64; f32 queries over a bf16
and an f32 latent), a ragged (3, 1000, 16) whose latent and rope key are
slices of one (B, S, 576) tensor, the smoke config's ranks (r 32, dr 16)
and a latent shorter than the queries (T = 600 < S = 1024, all bf16),
with one SDPA call over [q_lat || q_rope] and [c_kv || k_rope] as the
library yardstick; a bf16 latent runs on the tensor cores
(``mla_tc_kernel``, bounded at the bf16 tensor-core peak), an f32 one on
the CUDA cores (``mla_kernel``, at the f32 peak).  The small card-vs-CPU
check before phase 3 (n = 8, R = 2) runs ``degree`` through every backend
and ``betweenness``, ``random`` and reactive ``degree`` at p_fail 0.3
through the fused plane and the edge list.

Phases 3, 4, 6, 7, 13, 14 (b–e), 15 (a–c), 8, 9, 10, 11, 12, 16, 17,
18, 19, 20, 21 and 22 are the main path (phase 19 (b)'s ranks count in
their own processes and print their counts):
every launch counter is set to 0 just before each of them and read just
after, and each prints its launches by kernel and by operand shape (a
batched launch's shape starts ``E=<E>``; the kernel line sums them over
the paths as ``launches_by_shape``).  The script
imports nothing of JAX.
"""
import dataclasses
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # bf16 on the tensor cores, dense
N_NODES = 33
FFN_P, VGG_P = 118_282, 14_982_479
KERNELS = ("gossip_plane", "gossip_edges", "gossip_robust",
           "flash_attention", "rwkv_scan", "mla_attention", "gossip_mix")
SOURCES = {"gossip_plane": "gossip_mix.cu", "gossip_edges": "gossip_mix.cu",
           "gossip_mix": "gossip_mix.cu",
           "gossip_robust": "gossip_robust.cu",
           "flash_attention": "flash_attention.cu",
           "rwkv_scan": "ssm_scan.cu", "mla_attention": "mla_attention.cu"}
REPLACES = {"gossip_plane": "src/repro/kernels/gossip_mix.py:164",
            "gossip_edges": "src/repro/kernels/gossip_mix.py:268",
            "gossip_robust": "src/repro/kernels/gossip_mix.py:387",
            "flash_attention": "src/repro/kernels/flash_attention.py:86",
            "rwkv_scan": "src/repro/kernels/ssm_scan.py:86",
            "mla_attention": "src/repro/kernels/mla_attention.py:79",
            "gossip_mix": "src/repro/kernels/gossip_mix.py:546"}
# the wrapper modules under repro_torch.kernels
MODULES = {"gossip_plane": "gossip_mix", "gossip_edges": "gossip_mix",
           "gossip_robust": "gossip_mix", "gossip_mix": "gossip_mix",
           "flash_attention": "flash_attention", "rwkv_scan": "ssm_scan",
           "mla_attention": "mla_attention"}
ROBUST_CHUNK = 1 << 19          # plain-version columns per chunk
VGG_LEAVES, FFN_LEAVES = 35, 6
# single-trainer histories of phases 3, 6 and 13 (per node, every 4th
# round), which phase 14 holds its sweep grids' experiments to
HISTORIES = {}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=15):
    """Median device time of one call: a sleep kernel backs the queue up
    first, so the timed launches run back to back with no host gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound_ms(nbytes, flops, peak_flops=F32_FLOPS_PER_S):
    """The larger of bytes over the memory rate and operations over
    ``peak_flops`` (the f32 CUDA-core rate unless the kernel's work runs
    on the tensor cores), in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / peak_flops * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def copy_ms(x):
    """Device time of one device-to-device ``copy_`` of ``x``'s bytes (its
    rows with their padding, as one flat tensor): the rate a streaming
    kernel that reads ``x`` once and writes as many bytes can reach on
    this card, the yardstick beside ``library_ms``."""
    flat = x.as_strided((x.shape[0] * x.stride(0),), (1,))
    dst = flat.new_empty(flat.shape)
    ms = cuda_ms(lambda: dst.copy_(flat))
    del dst
    return ms


def issue_floor(name, case, lane_ops, ops):
    """A ``kernel_model`` line: ``lane_ops`` f32 lane instructions
    (``ops`` names them) over the card's CUDA cores, 128 lanes an SM at the
    SM clock's maximum (``nvidia-smi clocks.max.sm``).  A model of the
    arithmetic's issue time, not a measurement."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("kernel_model " + json.dumps({
        "name": name, "case": case, "modeled": True, "ops": ops,
        "lane_instructions": lane_ops, "sms": sms, "sm_clock_mhz": mhz,
        "issue_floor_ms": lane_ops / (sms * 128 * mhz * 1e6) * 1e3}))


def bf16_ulp(x):
    import torch

    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


# ----------------------------------------------------------------------
# phase 2: each kernel against its plain version at the path's shapes
# ----------------------------------------------------------------------
def check_kernels(dev):
    import torch

    from repro_torch.core.coeffs import program_for
    from repro_torch.core.mixing import edge_weights
    from repro_torch.core.plane import aligned_plane
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.kernels import gossip_mix as gm

    topo = barabasi_albert(N_NODES, 2, 0)
    program, state = program_for(topo, AggregationStrategy("degree"))
    c = program.matrix(state, 0).to(dev)
    nbr_idx, nbr_mask = topo.neighbor_tables()
    idx = torch.as_tensor(nbr_idx, device=dev)
    w = edge_weights(c, idx, torch.as_tensor(nbr_mask, device=dev))
    nnz = int((w != 0).sum())
    dmax = idx.shape[1]
    log(f"BA(33, 2, seed 0): dmax {dmax} (self included), {nnz} nonzero "
        f"coefficients")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape_name, p in (("ffn", FFN_P), ("vgg16", VGG_P)):
        for dtype in (torch.float32, torch.bfloat16):
            plane = aligned_plane(N_NODES, p, dtype, dev)
            plane.copy_(torch.randn((N_NODES, p), generator=gen, device=dev,
                                    dtype=torch.float32))
            b = plane.element_size()
            c_dt = c.to(dtype)
            # the library yardstick for both kernels: one dense product
            lib = lambda: torch.matmul(c_dt, plane)
            plane_copy_ms = copy_ms(plane)
            for name in ("gossip_plane", "gossip_edges"):
                if name == "gossip_plane":
                    run = lambda: gm.gossip_plane(plane, c)
                    plain = lambda: gm.gossip_plane_ref(plane, c)
                    nbytes = 2 * N_NODES * p * b + N_NODES * N_NODES * 4
                    flops = 2 * N_NODES * N_NODES * p
                else:
                    run = lambda: gm.gossip_edges(plane, w, idx)
                    plain = lambda: gm.gossip_edges_ref(plane, w, idx)
                    nbytes = 2 * N_NODES * p * b + N_NODES * dmax * 8
                    flops = 2 * nnz * p
                out = run().float()
                ref = plain().float()
                torch.cuda.synchronize()
                assert out.shape == (N_NODES, p) and bool(
                    torch.isfinite(out).all()), name
                err = (out - ref).abs()
                max_err = float(err.max())
                if dtype == torch.float32:
                    tol = 1e-5 * float(ref.abs().max())
                    ok = max_err <= tol
                    tol_txt = f"<= 1e-5*max|ref| = {tol:.3g}"
                else:
                    ok = bool((err <= bf16_ulp(ref)).all())
                    tol_txt = "<= 1 bf16 ulp elementwise"
                del out, ref, err
                assert ok, f"{name} {shape_name} {dtype}: {max_err} {tol_txt}"
                bnd, by = bound_ms(nbytes, flops)
                case = {
                    "name": name, "shape": [N_NODES, p],
                    "dtype": str(dtype).replace("torch.", ""),
                    "main": shape_name == "vgg16" and dtype == torch.float32,
                    "max_abs_err": max_err, "tolerance": tol_txt,
                    "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=5),
                    "library_ms": cuda_ms(lib), "copy_ms": plane_copy_ms,
                    "bound_ms": bnd, "bound_by": by,
                    "bytes": nbytes, "flops": flops,
                }
                log("kernel_case " + json.dumps(case))
                if name == "gossip_plane":
                    issue_floor(name, f"{shape_name} {case['dtype']}",
                                N_NODES * N_NODES * p, "fma")
                cases.append(case)
            cases += check_robust_kernel(gm, plane, w, idx, shape_name,
                                         plane_copy_ms)
            del plane
            torch.cuda.empty_cache()
    # the poisoned case: 3 rows of NaN / +Inf / -Inf on the FFN plane
    plane = aligned_plane(N_NODES, FFN_P, torch.float32, dev)
    plane.copy_(torch.randn((N_NODES, FFN_P), generator=gen, device=dev))
    plane[1] = float("nan")
    plane[4, ::3] = float("inf")
    plane[7] = float("-inf")
    cases += check_robust_kernel(gm, plane, w, idx, "ffn_poisoned",
                                 copy_ms(plane))
    return cases


GOSSIP_MIX_CASES = (
    # (label, (K, M, N), R, dtype, main); R None: weights (K,), R = 1
    ("vgg16_largest_leaf", (N_NODES, 1, 3 * 3 * 512 * 512), N_NODES,
     "float32", True),
    ("vgg16_largest_leaf", (N_NODES, 1, 3 * 3 * 512 * 512), N_NODES,
     "bfloat16", False),
    ("ffn_l1_w", (N_NODES, 1, 784 * 128), N_NODES, "float32", False),
    ("ragged_unaligned", (5, 513, 129), None, "float32", False),
    ("one_value_leaf", (N_NODES, 1, 1), N_NODES, "float32", False),
)


def check_gossip_mix(dev):
    """``gossip_mix`` against ``gossip_mix_ref``: max abs err 0 in f32,
    within one bf16 ulp in bf16 (the same unfused f32 arithmetic, so 0 is
    expected there too); the yardstick is one ``torch.matmul(w,
    blocks.view(K, -1))``.  Weights: the rows of BA(33, 2)'s ``degree``
    matrix, or a normalized random vector where K != 33."""
    import torch

    from repro_torch.core.coeffs import program_for
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.kernels import gossip_mix as gm

    program, state = program_for(barabasi_albert(N_NODES, 2, 0),
                                 AggregationStrategy("degree"))
    c = program.matrix(state, 0).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for label, (k, m, n), r, dt, main in GOSSIP_MIX_CASES:
        dtype = getattr(torch, dt)
        blocks = torch.randn((k, m, n), generator=gen, device=dev).to(dtype)
        if k == N_NODES:
            w = c if r else c[0]
        else:
            w = torch.rand((k,) if r is None else (r, k), generator=gen,
                           device=dev)
            w = w / w.sum(-1, keepdim=True)
        rows = 1 if r is None else r
        run = lambda: gm.gossip_mix(blocks, w)
        plain = lambda: gm.gossip_mix_ref(blocks, w)
        wl = w.to(dtype)
        lib = lambda: torch.matmul(wl, blocks.view(k, -1))
        out, ref = run(), plain()
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.float32:
            ok, tol_txt = max_err == 0.0, "== 0"
        else:
            ok = bool((err <= bf16_ulp(ref.float())).all())
            tol_txt = "<= 1 bf16 ulp elementwise"
        del out, ref, err
        assert ok, ("gossip_mix", label, dt, max_err, tol_txt)
        b = blocks.element_size()
        nbytes = (k + rows) * m * n * b + 4 * rows * k
        flops = 2 * rows * k * m * n
        bnd, by = bound_ms(nbytes, flops)
        case = {
            "name": "gossip_mix", "case": label, "shape": [k, m, n],
            "rows": rows, "dtype": dt, "main": main,
            "max_abs_err": max_err, "tolerance": tol_txt,
            "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=5),
            "library_ms": cuda_ms(lib), "library": "torch.matmul",
            "copy_ms": copy_ms(blocks),
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes,
            "flops": flops,
        }
        log("kernel_case " + json.dumps(case))
        # the unfused multiply and add: two lane instructions a MAC
        issue_floor("gossip_mix", f"{label} {dt}", 2 * rows * k * m * n,
                    "fmul+fadd")
        cases.append(case)
        del blocks
        torch.cuda.empty_cache()
    return cases


def exact_err(a, b) -> float:
    """Max abs difference, NaN against NaN counting as equal (and inf when
    NaN stands in one output only)."""
    import torch

    if not bool((a.isnan() == b.isnan()).all()):
        return float("inf")
    same = (a == b) | a.isnan()
    return float(torch.where(same, torch.zeros_like(a), (a - b).abs()).max())


def robust_lane_instructions(w, p, op, trim_k):
    """The robust kernel's lane instructions on these inputs, from its
    design (csrc/gossip_robust.cu): for each column, 5 a compare-select
    step of the stable insertion (a compare, two key and two weight
    selects; cnt_i (cnt_i - 1) / 2 steps for row i's cnt_i occupied
    slots), 5 a gathered value (its table offset and weight, the read,
    two clamps), and 3 a kept value's unfused sum (trimmed) or 2 a row
    (median)."""
    k = (w > 0).sum(1)
    per_col = 5 * int((k * (k - 1) // 2).sum()) + 5 * int(k.sum())
    if op == "trimmed":
        per_col += 3 * int((k - 2 * trim_k).clamp_min(0).sum())
    else:
        per_col += 2 * w.shape[0]
    return per_col * p


def robust_operations(w, p, op, trim_k):
    """Operations the robust rule needs on these inputs: for each column,
    the compare-exchanges that sort each row's k_i occupied values
    (k_i (k_i - 1) / 2, one operation each) plus the arithmetic on what
    survives (trimmed: a multiply and two adds per kept value and one
    division per row; median: an add and a multiply per row)."""
    k = (w > 0).sum(1)
    per_col = int((k * (k - 1) // 2).sum())
    if op == "trimmed":
        per_col += 3 * int((k - 2 * trim_k).clamp_min(0).sum()) + w.shape[0]
    else:
        per_col += 2 * w.shape[0]
    return per_col * p


def check_robust_kernel(gm, plane, w, idx, shape_name, plane_copy_ms):
    """``gossip_robust`` against ``gossip_robust_ref`` on one plane, for
    the trimmed mean (k = 1) and the median, to max abs err 0.  The plain
    version gathers a (dmax, n, columns) tensor (29.7 GB at the VGG-16
    plane), so it runs over column chunks — columns are independent, so
    chunking is exact — and plain_ms is the sum of the chunk times.
    ``copy_ms``: one ``copy_`` of the plane (no PyTorch call computes the
    rule, so the streaming rate is the yardstick)."""
    import torch

    n, p = plane.shape
    b = plane.element_size()
    cases = []
    for op, trim_k in (("trimmed", 1), ("median", 0)):
        run = lambda: gm.gossip_robust(plane, w, idx, op, trim_k)
        out = run()
        torch.cuda.synchronize()
        assert out.shape == (n, p), out.shape
        max_err, plain_ms = 0.0, 0.0
        gm.gossip_robust_ref(plane[:, :1024], w, idx, op, trim_k)  # warm up
        for c0 in range(0, p, ROBUST_CHUNK):
            c1 = min(p, c0 + ROBUST_CHUNK)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            ref = gm.gossip_robust_ref(plane[:, c0:c1], w, idx, op, trim_k)
            t1.record()
            torch.cuda.synchronize()
            plain_ms += t0.elapsed_time(t1)
            max_err = max(max_err, exact_err(out[:, c0:c1].float(),
                                             ref.float()))
            del ref
        if "poisoned" not in shape_name:
            assert bool(torch.isfinite(out).all()), (shape_name, op)
        del out
        assert max_err == 0.0, ("gossip_robust", shape_name, op, max_err)
        nbytes = 2 * n * p * b + n * idx.shape[1] * 8
        ops = robust_operations(w, p, op, trim_k)
        bnd, by = bound_ms(nbytes, ops)
        case = {
            "name": "gossip_robust", "shape": [n, p],
            "dtype": str(plane.dtype).replace("torch.", ""),
            "plane": shape_name, "op": op, "trim_k": trim_k,
            "main": (shape_name == "vgg16" and plane.dtype == torch.float32
                     and op == "trimmed"),
            "max_abs_err": max_err,
            "tolerance": "== 0 (NaN where the plain version has NaN)",
            "ms": cuda_ms(run), "plain_ms": plain_ms, "library_ms": None,
            "copy_ms": plane_copy_ms, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "operations": ops,
        }
        log("kernel_case " + json.dumps(case))
        issue_floor("gossip_robust", f"{shape_name} {case['dtype']} {op}",
                    robust_lane_instructions(w, p, op, trim_k),
                    "5 a sort step, 5 a gather, 3 a kept sum")
        cases.append(case)
    return cases


# ----------------------------------------------------------------------
# phase 3: Algorithm 1 at paper scale, FFN
# ----------------------------------------------------------------------
def ffn_setup(topo=None):
    """The quickstart scenario on BA(33, 2), or on ``topo``: OOD data on
    the highest-degree node."""
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.data.backdoor import backdoored_testset
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher, make_test_batch
    from repro_torch.data.synthetic import make_dataset

    topo = barabasi_albert(N_NODES, 2, 0) if topo is None else topo
    ood = topo.kth_highest_degree_node(1)
    train = make_dataset("mnist", 20000, seed=0)
    test = make_dataset("mnist", 2000, seed=123)
    parts = node_datasets(train, N_NODES, ood_node=ood, q=0.10, seed=0)
    batcher = NodeBatcher(parts, batch_size=32, steps_per_epoch=0,
                          local_epochs=5)
    return dict(topo=topo, ood=ood, batcher=batcher,
                test_iid=make_test_batch(test, 512),
                test_ood=make_test_batch(backdoored_testset(test), 512))


def ffn_trainer(sc, strategy, mix_impl, rounds, eval_every, device="cuda",
                coeffs_fn=None, **cfg):
    from repro_torch.core.decentralized import (
        DecentralizedConfig,
        DecentralizedTrainer,
    )
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.models.paper_models import (
        classifier_accuracy,
        classifier_loss,
        ffn_apply,
    )
    from repro_torch.training.optimizer import sgd

    return DecentralizedTrainer(
        sc["topo"], AggregationStrategy(strategy, tau=0.1), sgd(1e-2),
        classifier_loss(ffn_apply), classifier_accuracy(ffn_apply),
        DecentralizedConfig(rounds=rounds, local_epochs=5,
                            eval_every=eval_every, mix_impl=mix_impl, **cfg),
        data_counts=sc["batcher"].data_counts(), coeffs_fn=coeffs_fn,
        device=device)


def ffn_params(device="cuda"):
    import torch

    from repro_torch.core.decentralized import stack_params
    from repro_torch.models.paper_models import ffn_init

    return stack_params([ffn_init(torch.Generator().manual_seed(0),
                                  device=device)] * N_NODES)


def max_drift_samples(ha, hb, n_eval):
    return max(float(abs(getattr(a, k) - getattr(b, k)).max()) * n_eval
               for a, b in zip(ha, hb) for k in ("iid_acc", "ood_acc"))


def small_device_check():
    """A small input on the card against the same run on the CPU (the
    plain versions): n = 8, R = 2, every backend."""
    import numpy as np
    import torch

    from repro_torch.core.decentralized import stack_params
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.data.backdoor import backdoored_testset
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher, make_test_batch
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.paper_models import ffn_init

    topo = barabasi_albert(8, 2, 0)
    test = make_dataset("mnist", 200, seed=123)
    sc = dict(topo=topo, batcher=NodeBatcher(
        node_datasets(make_dataset("mnist", 800, seed=0), 8,
                      ood_node=topo.kth_highest_degree_node(1), seed=0),
        16, steps_per_epoch=3, local_epochs=5),
        test_iid=make_test_batch(test, 200),
        test_ood=make_test_batch(backdoored_testset(test), 200))
    worst = 0.0
    cases = [("degree", impl, robust, 0.0)
             for impl, robust in (("einsum", "mean"), ("pallas", "mean"),
                                  ("edges", "mean"), ("edges", "trimmed"),
                                  ("sparse", "mean"))]
    cases += [(kind, impl, "mean", p_fail)
              for kind, p_fail in (("betweenness", 0.0), ("random", 0.0),
                                   ("degree", 0.3))
              for impl in ("pallas", "edges")]
    for strategy, impl, robust, p_fail in cases:
        hists = []
        for device in ("cuda", "cpu"):
            params = stack_params([ffn_init(torch.Generator().manual_seed(0),
                                            device=device)] * 8)
            coeffs_fn = (linkfail_coeffs_fn(sc, strategy, p_fail, True, 2)
                         if p_fail else None)
            tr = ffn_trainer(sc, strategy, impl, 2, 1, device=device,
                             coeffs_fn=coeffs_fn, robust=robust)
            hists.append(tr.run(params, sc["batcher"].round_batches,
                                sc["test_iid"], sc["test_ood"])[1])
        for h in hists[0]:
            assert np.all(np.isfinite(h.train_loss))
        worst = max(worst, max_drift_samples(*hists, 200))
    # card vs CPU differ only in summation order: at most one eval sample
    assert worst <= 1 + 1e-3, worst
    log(f"small input, card vs CPU, every backend (sparse: BA(8, 2) keeps "
        f"its ring schedule), the robust kernel, and betweenness, random "
        f"and reactive degree at p_fail 0.3 through pallas and edges: "
        f"max per-node drift "
        f"{worst:.0f} of 200 eval samples (limit 1)")


def linkfail_coeffs_fn(sc, strategy, p_fail, reactive, rounds):
    """The legacy loop of ``ablations.run_link_failure``: a coefficient
    program with ``p_fail`` (reactive: centralities recomputed on each
    round's survivor), its rounds materialized once and handed to the
    trainer as ``coeffs_fn``."""
    from repro_torch.core.coeffs import program_for
    from repro_torch.core.strategies import AggregationStrategy

    program, state = program_for(
        sc["topo"], AggregationStrategy(strategy, tau=0.1),
        data_counts=sc["batcher"].data_counts(), p_fail=p_fail,
        reactive=reactive)
    stack = program.materialize(state, rounds)
    return stack.__getitem__


def run_ffn(sc, gm, batches):
    """Phase 3: ``unweighted`` and ``degree`` for 40 rounds, then the four
    backends for 3; ``batches`` holds each round's host batches, which
    the trainer copies to the card every round."""
    from repro_torch.core.propagation import (
        accuracy_auc,
        render_propagation_map,
    )

    results = {}
    for strategy in ("unweighted", "degree"):
        tr = ffn_trainer(sc, strategy, "pallas", 40, 4)
        before = gm.gossip_plane.launches
        t0 = time.perf_counter()
        _, hist = tr.run(ffn_params(), batches.__getitem__,
                         sc["test_iid"], sc["test_ood"])
        secs = time.perf_counter() - t0
        HISTORIES[strategy] = hist
        launches = gm.gossip_plane.launches - before
        assert launches == 40, launches   # one kernel launch per mix
        res = {"iid_auc": accuracy_auc(hist, "iid"),
               "ood_auc": accuracy_auc(hist, "ood"),
               "s_per_round": secs / 40, "launches": launches,
               "final_ood_acc": float(hist[-1].ood_acc.mean())}
        log(f"ffn {strategy} " + json.dumps(res))
        log(render_propagation_map(hist, sc["topo"].adjacency, sc["ood"]))
        results[strategy] = res
    assert results["degree"]["ood_auc"] > results["unweighted"]["ood_auc"], \
        results
    hists = {}
    counters = (gm.gossip_plane, gm.gossip_edges, gm.gossip_mix)
    for impl in ("einsum", "pallas", "edges", "sparse"):
        tr = ffn_trainer(sc, "degree", impl, 3, 1)
        counts = [c.launches for c in counters]
        _, hists[impl] = tr.run(ffn_params(), batches.__getitem__,
                                sc["test_iid"], sc["test_ood"])
        delta = tuple(c.launches - b for c, b in zip(counters, counts))
        assert delta == {"einsum": (0, 0, 0), "pallas": (3, 0, 0),
                         "edges": (0, 3, 0), "sparse": (0, 0, 0)}[impl], \
            (impl, delta)
    drift = max(max_drift_samples(hists["pallas"], hists[i], 512)
                for i in ("einsum", "edges"))
    # the backends sum in different orders; after 3 rounds of training a
    # borderline sample may flip: allow 3 of 512 per node
    assert drift <= 3 + 1e-3, drift
    log(f"ffn 3 rounds einsum/pallas/edges: max per-node drift {drift:.0f} "
        f"of 512 eval samples (limit 3)")
    # BA(33, 2) needs all 33 ring offsets against a max degree of 14: the
    # sparse schedule falls back to the einsum, so its history is einsum's
    import numpy as np

    from repro_torch.core.decentralized import sparse_schedule

    topo = sc["topo"]
    assert sparse_schedule(topo.adjacency + np.eye(topo.n_nodes))[0] is None
    for a, b in zip(hists["sparse"], hists["einsum"]):
        for key in ("iid_acc", "ood_acc", "train_loss"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
    log("ffn 3 rounds sparse on BA(33, 2): the fallback fired (no kernel "
        "launched, history equal to einsum's)")
    return results


# ----------------------------------------------------------------------
# phase 4: VGG-16 at full width
# ----------------------------------------------------------------------
def vgg_setup():
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.data.backdoor import backdoored_testset
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher, make_test_batch
    from repro_torch.data.synthetic import make_dataset

    topo = barabasi_albert(N_NODES, 2, 0)
    ood = topo.kth_highest_degree_node(1)
    test = make_dataset("cifar10", 512, seed=123)
    parts = node_datasets(make_dataset("cifar10", 8000, seed=0), N_NODES,
                          ood_node=ood, q=0.10, seed=0)
    return dict(topo=topo, batcher=NodeBatcher(parts, 32, steps_per_epoch=4,
                                               local_epochs=1),
                test_iid=make_test_batch(test, 128),
                test_ood=make_test_batch(backdoored_testset(test), 128))


def vgg_trainer(sc, mix_impl, rounds, robust="mean"):
    from repro_torch.core.decentralized import (
        DecentralizedConfig,
        DecentralizedTrainer,
    )
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.models.paper_models import (
        classifier_accuracy,
        classifier_loss,
        vgg_apply,
    )
    from repro_torch.training.optimizer import adam

    return DecentralizedTrainer(
        sc["topo"], AggregationStrategy("degree", tau=0.1), adam(1e-4),
        classifier_loss(vgg_apply), classifier_accuracy(vgg_apply),
        DecentralizedConfig(rounds=rounds, local_epochs=1, eval_every=1,
                            mix_impl=mix_impl, robust=robust),
        data_counts=sc["batcher"].data_counts())


def vgg_params():
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core.decentralized import stack_params
    from repro_torch.models.paper_models import vgg_init

    one = vgg_init(torch.Generator().manual_seed(0), device="cuda")
    p = sum(x.numel() for x in tree_util.leaves(one))
    assert p == VGG_P and len(tree_util.leaves(one)) == 35, p
    return stack_params([one] * N_NODES)


def run_vgg(sc, gm):
    import numpy as np
    import torch

    from repro_torch import tree as tree_util

    out = {}
    for impl, robust, rounds, counter in (
            ("pallas", "mean", 2, gm.gossip_plane),
            ("edges", "mean", 1, gm.gossip_edges),
            ("edges", "trimmed", 1, gm.gossip_robust)):
        before = counter.launches
        t0 = time.perf_counter()
        params, hist = vgg_trainer(sc, impl, rounds, robust).run(
            vgg_params(), sc["batcher"].round_batches, sc["test_iid"],
            sc["test_ood"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert counter.launches - before == rounds, (impl, counter.launches)
        for h in hist:
            assert np.all(np.isfinite(h.train_loss)), h.train_loss
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_util.leaves(params))
        key = impl if robust == "mean" else f"{impl}_{robust}"
        out[key] = {"rounds": rounds, "s_per_round": secs / rounds,
                    "train_loss_mean": [float(h.train_loss.mean())
                                        for h in hist]}
        log(f"vgg16 {key} " + json.dumps(out[key]))
        del params
    return out


# ----------------------------------------------------------------------
# phases 6-7: the robust trainer and the fault layer, FFN at paper scale
# ----------------------------------------------------------------------
ROUNDS = 40


def host_batches(sc, rounds):
    """Each round's node batches as the host builds them (numpy, 12 GB for
    40 FFN rounds).  ``round_batches(r)`` is a function of r alone, so a
    scenario's are built once, while the kernels compile, and every run
    of it reads them: phase 3 through the trainer's copy each round, the
    later phases through ``device_batches``."""
    return [sc["batcher"].round_batches(r) for r in range(rounds)]


def device_batches(host):
    """``host_batches`` kept on the card (12 GB for 40 rounds), so the
    runs of phases 6-7 share them and their s/round leaves out the
    host-to-card copy that phase 3 includes."""
    import torch

    from repro_torch import tree as tree_util

    return [tree_util.tree_map(lambda x: torch.as_tensor(x, device="cuda"),
                               b) for b in host]


def all_finite(params) -> bool:
    import torch

    from repro_torch import tree as tree_util

    return all(bool(torch.isfinite(x).all())
               for x in tree_util.leaves(params))


def run_robust_ffn(sc, gm, batches, mean_res, rounds=None):
    """Phase 6: ``DecentralizedTrainer`` with the robust rules, cut to
    ``ROBUST_CUT_ROUNDS`` rounds."""
    import torch

    from repro_torch.core.propagation import accuracy_auc

    rounds = rounds or ROBUST_CUT_ROUNDS
    cut_line(6, "ffn_robust", rounds)
    out = {}
    for robust, impl, counter in (("trimmed", "edges", gm.gossip_robust),
                                  ("norm_clip", "pallas", gm.gossip_plane)):
        tr = ffn_trainer(sc, "degree", impl, rounds, 4, robust=robust,
                         robust_trim=1)
        before = counter.launches
        t0 = time.perf_counter()
        params, hist = tr.run(ffn_params(), batches.__getitem__,
                              sc["test_iid"], sc["test_ood"])
        HISTORIES[f"robust_{robust}"] = hist
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = counter.launches - before
        assert launches == rounds, (robust, launches)  # one launch per mix
        assert all_finite(params), robust
        res = {"mix_impl": impl, "iid_auc": accuracy_auc(hist, "iid"),
               "ood_auc": accuracy_auc(hist, "ood"), "rounds": rounds,
               "s_per_round": secs / rounds, "launches": launches,
               "final_ood_acc": float(hist[-1].ood_acc.mean())}
        log(f"ffn degree robust={robust} " + json.dumps(res))
        out[robust] = res
    assert out["trimmed"]["iid_auc"] >= 0.9, out["trimmed"]
    log(f"ffn degree OOD AUC, robustness against OOD propagation: mean "
        f"(phase 3, R = {ROUNDS}) {mean_res['ood_auc']:.4f}; R = {rounds}: "
        f"trimmed "
        f"{out['trimmed']['ood_auc']:.4f}, norm_clip "
        f"{out['norm_clip']['ood_auc']:.4f}")
    return out


def drive_rounds(sc, round_fn, batches, init_carries=None,
                 rounds=ROUNDS):
    """``rounds`` rounds of a round function from the phase-3 init with
    the degree matrix, evaluated every 4th round as the trainer does;
    ``init_carries`` (params -> list of carries) selects the fault-round
    signature."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core.decentralized import RoundMetrics, eval_round_indices
    from repro_torch.models.paper_models import classifier_accuracy, ffn_apply
    from repro_torch.training.optimizer import sgd

    params = ffn_params()
    opt = sgd(1e-2).init(params)
    carries = init_carries(params) if init_carries else None
    coeffs = trainer_coeffs(sc)
    eval_v = torch.func.vmap(classifier_accuracy(ffn_apply), in_dims=(0, None))
    to_dev = lambda t: tree_util.tree_map(
        lambda x: torch.as_tensor(x, device="cuda"), t)
    tests = to_dev(sc["test_iid"]), to_dev(sc["test_ood"])
    keep = set(eval_round_indices(rounds, 4))
    hist = []
    for r in range(rounds):
        if carries is None:
            params, opt, losses = round_fn(params, opt, batches[r], coeffs)
        else:
            params, opt, *carries, losses = round_fn(
                params, opt, *carries, batches[r], coeffs, r)
        if r in keep:
            with torch.no_grad():
                iid, ood = (eval_v(params, t) for t in tests)
            hist.append(RoundMetrics(round=r, iid_acc=iid.cpu().numpy(),
                                     ood_acc=ood.cpu().numpy(),
                                     train_loss=losses.cpu().numpy()))
    torch.cuda.synchronize()
    return params, carries, hist


def within_breakdown(sc, spec, rate, fseed, rule, rounds=ROUNDS):
    """Whether the drawn faulty sets leave every neighbourhood (self
    included) within the rule's breakdown point in every round: at most
    trim_k = 1 faulty rows for the trimmed mean, fewer than half for the
    median."""
    import numpy as np

    sup = sc["topo"].adjacency + np.eye(N_NODES)
    size = sup.sum(1)
    for r in range(rounds):
        bad = sup @ spec.faulty_mask(rate, fseed, r, N_NODES)
        if rule == "trimmed" and (bad > 1).any():
            return False
        if rule == "median" and (2 * bad >= size).any():
            return False
    return True


# phase 7's rounds: the fault gates (rate 0 bit for bit, NaN contained
# by the quarantine and not by the mean, sign-flip under the robust
# rules) hold round by round, so they run 10 of phase 3's 40
FAULT_CUT_ROUNDS = 10
# phase 6's rounds: its trimmed run's IID AUC is 0.998 at 40 rounds,
# far above its 0.9 gate, and phase 14 (e) holds its first 10 rounds
ROBUST_CUT_ROUNDS = 20


def run_faults(sc, gm, batches, rounds=FAULT_CUT_ROUNDS):
    """Phase 7: ``make_fault_round_fn`` for ``rounds`` rounds at the
    phase-3 scale."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core.decentralized import (
        fault_carry_init,
        make_fault_round_fn,
        make_round_fn,
    )
    from repro_torch.core.dynamic import FaultSpec
    from repro_torch.core.propagation import accuracy_auc
    from repro_torch.models.paper_models import classifier_loss, ffn_apply
    from repro_torch.training.optimizer import sgd

    loss = classifier_loss(ffn_apply)
    support = sc["topo"].adjacency + np.eye(N_NODES)
    out = {}
    cut_line(7, "ffn_faults", rounds)

    def fault_run(label, spec, rate, fseed, robust="mean", impl="pallas"):
        counter = gm.gossip_robust if impl == "edges" else gm.gossip_plane
        fn = make_fault_round_fn(loss, sgd(1e-2), 5, spec, mix_impl=impl,
                                 mix_support=support, robust=robust,
                                 robust_trim=1, device="cuda")
        before = counter.launches
        t0 = time.perf_counter()
        params, (fc,), hist = drive_rounds(
            sc, fn, batches, lambda p: [fault_carry_init(p, rate, fseed)],
            rounds)
        secs = time.perf_counter() - t0
        assert counter.launches - before == rounds, (label, counter.launches)
        res = {"mode": spec.mode, "quarantine": spec.quarantine,
               "robust": robust, "mix_impl": impl, "rate": rate,
               "fseed": fseed, "finite": all_finite(params),
               "faulty_node_rounds": int(fc["fault_rounds"].sum()),
               "quarantined_node_rounds": int(fc["rounds_quarantined"].sum()),
               "iid_auc": accuracy_auc(hist, "iid"),
               "ood_auc": accuracy_auc(hist, "ood"),
               "s_per_round": secs / rounds}
        log(f"faults {label} " + json.dumps(res))
        out[label] = res
        return params, fc

    # rate 0 is the synchronous round, bit for bit, on the same backend
    plain = make_round_fn(loss, sgd(1e-2), 5, mix_impl="pallas",
                          device="cuda")
    ref, _, _ = drive_rounds(sc, plain, batches, rounds=rounds)
    zero, _ = fault_run("rate0_mean", FaultSpec(mode="nan"), 0.0, 1)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(zero),
                                                 tree_util.leaves(ref)))
    log("faults rate 0 == make_round_fn: bit-identical parameters after "
        f"{rounds} rounds")
    del ref, zero

    # NaN faults: the quarantine screen contains them, the mean does not
    rate, fseed = 0.05, 1
    params, fc = fault_run("nan_quarantine", FaultSpec(mode="nan",
                                                       quarantine=True),
                           rate, fseed)
    faulted = fc["fault_rounds"] > 0
    assert bool(faulted.any())
    assert out["nan_quarantine"]["finite"]
    assert torch.equal(fc["first_quar"][faulted], fc["first_fault"][faulted])
    assert bool((fc["quar_fault_rounds"][faulted] > 0).all())
    params, _ = fault_run("nan_mean_control", FaultSpec(mode="nan"), rate,
                          fseed)
    assert not out["nan_mean_control"]["finite"]
    del params

    # sign-flip faults: the first fseed whose draws keep every
    # neighbourhood within the trimmed mean's breakdown point (at 2% a
    # neighbourhood of 15 holds two faulty rows in 3.6% of rounds)
    spec = FaultSpec(mode="signflip", byz_scale=3.0)
    rate = 0.02
    fseed = next(f for f in range(200)
                 if within_breakdown(sc, spec, rate, f, "trimmed", rounds))
    for robust, impl in (("mean", "pallas"), ("median", "edges"),
                         ("trimmed", "edges")):
        fault_run(f"signflip_{robust}", spec, rate, fseed, robust, impl)
        if robust != "mean" and within_breakdown(sc, spec, rate, fseed,
                                                 robust, rounds):
            assert out[f"signflip_{robust}"]["finite"], robust
    log("faults signflip x3 at rate {} fseed {}: final IID/OOD AUC {}".format(
        rate, fseed, {r: (round(out[f"signflip_{r}"]["iid_auc"], 4),
                          round(out[f"signflip_{r}"]["ood_auc"], 4))
                      for r in ("mean", "median", "trimmed")}))
    return out


# ----------------------------------------------------------------------
# phase 13: every strategy, link failure, the modular graphs (FFN)
# ----------------------------------------------------------------------
SB_P_OUTS = (0.009, 0.05, 0.9)
# every run of phase 13 takes 10 of FULL's 40 rounds (20 until phase 19
# needed the room); the paper's claim at 40 is phase 3's (degree) and
# phase 18 (a)'s (all six Fig. 4 strategies)
PHASE13_CUT_ROUNDS = 10


def reduced_line(phase, path, what, frm, to):
    """One cut of a path, printed as a ``reduced`` line."""
    log("reduced " + json.dumps({"phase": phase, "path": path, "what": what,
                                 "from": frm, "to": to}))


def cut_line(phase, path, rounds):
    if rounds < ROUNDS:
        reduced_line(phase, path, "rounds", ROUNDS, rounds)


def ffn_run(sc, strategy, mix_impl, batches, counter, rounds=ROUNDS,
            eval_every=4, coeffs_fn=None):
    """One trainer run from the phase-3 init on the card's batches:
    ``(trainer, history, result)``, exactly one ``counter`` launch a
    round."""
    import torch

    from repro_torch.core.propagation import accuracy_auc

    tr = ffn_trainer(sc, strategy, mix_impl, rounds, eval_every,
                     coeffs_fn=coeffs_fn)
    before = counter.launches
    t0 = time.perf_counter()
    _, hist = tr.run(ffn_params(), batches.__getitem__, sc["test_iid"],
                     sc["test_ood"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counter.launches - before
    assert launches == rounds, (strategy, mix_impl, launches)
    return tr, hist, {"mix_impl": mix_impl,
                      "iid_auc": accuracy_auc(hist, "iid"),
                      "ood_auc": accuracy_auc(hist, "ood"),
                      "s_per_round": secs / rounds, "launches": launches}


def run_strategies(sc, gm, batches, ffn_res, rounds=PHASE13_CUT_ROUNDS):
    """Phase 13 (a): Fig. 4's other four strategies at the paper's scale
    through the fused plane, cut to ``rounds``, beside phase 3's
    ``unweighted`` and ``degree``; their histories hold phase 14 (b)'s
    grid on its first ``rounds`` rounds."""
    import numpy as np

    cut_line(13, "ffn_strategies", rounds)
    out = {}
    for strategy in ("fl", "weighted", "random", "betweenness"):
        tr, HISTORIES[strategy], res = ffn_run(sc, strategy, "pallas",
                                               batches, gm.gossip_plane,
                                               rounds=rounds)
        log(f"ffn {strategy} " + json.dumps(res))
        out[strategy] = res
        if strategy == "random":
            c = tr.coeffs_stack()
            support = sc["topo"].adjacency + np.eye(N_NODES) > 0
            assert c.shape == (rounds, N_NODES, N_NODES)
            assert np.allclose(c.sum(-1), 1.0, atol=1e-6)
            assert bool((c >= 0).all()) and not bool((c[:, ~support] > 0).any())
            assert any(not np.array_equal(c[0], c[r]) for r in range(1, rounds))
            log(f"ffn random: {rounds} row-stochastic matrices on adj + I, "
                f"{len({c[r].tobytes() for r in range(rounds)})} distinct")
    aucs = {k: round(v["ood_auc"], 4) for k, v in ffn_res.items()}
    aucs.update({k: round(v["ood_auc"], 4) for k, v in out.items()})
    log(f"fig4 OOD AUC, six strategies (BA(33, 2), OOD on the hub, R = "
        f"{ROUNDS} for unweighted and degree, {rounds} for the others): "
        f"{json.dumps(aucs)}")
    return out


def run_linkfail(sc, gm, batches, ffn_res, rounds=PHASE13_CUT_ROUNDS):
    """Phase 13 (b): ``degree`` at p_fail 0.3, nominal and reactive, its
    program's matrices through ``coeffs_fn`` and the edge-list kernel."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.core.dynamic import edge_mask

    cut_line(13, "ffn_linkfail", rounds)
    adj = sc["topo"].adjacency
    p_fail = 0.3
    out = {}
    for reactive in (False, True):
        fn = linkfail_coeffs_fn(sc, "degree", p_fail, reactive, rounds)
        tr, HISTORIES[f"linkfail_{reactive}"], res = ffn_run(
            sc, "degree", "edges", batches, gm.gossip_edges, rounds=rounds,
            coeffs_fn=fn)
        dropped = 0
        for r in range(rounds):
            c = fn(r)
            keep = edge_mask(prng.fold_in(prng.fold_in(prng.key(0), r), 0),
                             N_NODES, p_fail)
            surv = adj * keep
            dropped += int((adj - surv).sum()) // 2
            assert np.allclose(c.sum(-1), 1.0, atol=1e-6), r
            assert not bool((c[surv + np.eye(N_NODES) == 0] > 0).any()), r
        assert dropped > 0
        res.update(p_fail=p_fail, reactive=reactive,
                   edges_dropped_per_round=dropped / rounds)
        label = "reactive" if reactive else "nominal"
        log(f"ffn degree p_fail={p_fail} {label} " + json.dumps(res))
        out[label] = res
    # the reactive program through the fused plane against the edge list
    fn = linkfail_coeffs_fn(sc, "degree", p_fail, True, 3)
    hists = [ffn_run(sc, "degree", impl, batches, counter, rounds=3,
                     eval_every=1, coeffs_fn=fn)[1]
             for impl, counter in (("edges", gm.gossip_edges),
                                   ("pallas", gm.gossip_plane))]
    drift = max_drift_samples(*hists, 512)
    assert drift <= 3 + 1e-3, drift
    log(f"ffn degree p_fail={p_fail} reactive, 3 rounds edges/pallas: max "
        f"per-node drift {drift:.0f} of 512 eval samples (limit 3)")
    log("ffn degree OOD AUC under link failure: p_fail 0 (phase 3) "
        f"{ffn_res['degree']['ood_auc']:.4f}, p_fail {p_fail} nominal "
        f"{out['nominal']['ood_auc']:.4f}, reactive "
        f"{out['reactive']['ood_auc']:.4f}")
    return out


def sb_setup():
    """Phase 13 (c)'s scenario: the FFN on the most modular SB graph."""
    from repro_torch.core.topology import stochastic_block

    return ffn_setup(stochastic_block(N_NODES, 3, 0.5, SB_P_OUTS[0], 0))


def run_sb(gm, sc, host, rounds=PHASE13_CUT_ROUNDS):
    """Phase 13 (c): Fig. 6's SB(33, 3, 0.5, p_out) graphs; on the most
    modular one (``sc``, its round batches ``host``), ``unweighted`` and
    ``degree`` with the OOD data on its highest-degree node."""
    from repro_torch.core.topology import stochastic_block

    cut_line(13, "sb_modularity", rounds)
    out = {}
    for p_out in SB_P_OUTS:
        topo = stochastic_block(N_NODES, 3, 0.5, p_out, 0)
        assert topo.is_connected(), p_out
        out[f"pout{p_out}"] = {"modularity": topo.modularity(),
                               "connected": topo.is_connected(),
                               "edges": topo.n_edges}
    log(f"sb(33, 3, 0.5, p_out) seed 0: {json.dumps(out)}")
    batches = device_batches(host[:rounds])
    for strategy in ("unweighted", "degree"):
        _, _, res = ffn_run(sc, strategy, "pallas", batches, gm.gossip_plane,
                            rounds=rounds)
        res["ood_node"] = sc["ood"]
        log(f"sb pout{SB_P_OUTS[0]} ffn {strategy} " + json.dumps(res))
        out[strategy] = res
    del batches
    log(f"sb pout{SB_P_OUTS[0]} OOD AUC: unweighted "
        f"{out['unweighted']['ood_auc']:.4f}, degree "
        f"{out['degree']['ood_auc']:.4f} (no gate on the order)")
    return out


# ----------------------------------------------------------------------
# phase 14: the paper's grids through the sweep engine (FFN)
# ----------------------------------------------------------------------
# (c): the unrolled run and the resumed tail; (d), (e): the link-failure
# and Byzantine grids, held by drift on phase 13's and phase 6's first 10
# rounds (20 until phase 19 needed the room)
SWEEP_CUT_ROUNDS = 10
# (b) and (c): 4 chunks of 6 rounds, so that (c)'s middle checkpoint,
# round 12, is an evaluation round (FULL evaluates every 4), as the
# unrolled run cut there evaluates its last round
FIG4_GRID_ROUNDS = 24
# per-node drift of an engine experiment from its single-trainer run, in
# eval samples of 512 (max over nodes and eval rounds).  Measured on the
# H100: 0 for all six Fig. 4 strategies, nominal and reactive link
# failure and the Byzantine rate-0 run (LocalTrain over E·n folded nodes
# and the batched mixes change no accuracy); pinned there
SWEEP_DRIFT_SAMPLES = 0


def batched_case(name, label, e, run, single, plain, lib, nbytes, ops,
                 plane, extra=None):
    """One batched kernel against E single launches of the same kernel on
    the same operands (max abs err 0, NaN where they have NaN), with its
    CUDA-event median, the E singles' time back to back, the plain
    version's (E plain calls), the library call's and the byte bound."""
    import torch

    out = run()
    singles = torch.stack([single(i) for i in range(e)])
    torch.cuda.synchronize()
    err = exact_err(out.float(), singles.float())
    del out, singles
    assert err == 0.0, (name, label, err)
    bnd, by = bound_ms(nbytes, ops)
    case = {
        "name": name, "shape": [e] + list(plane.shape[1:]),
        "dtype": str(plane.dtype).replace("torch.", ""), "plane": label,
        "experiments": e, "main": False, "max_abs_err": err,
        "tolerance": "== 0 against E single launches",
        "ms": cuda_ms(run),
        "singles_ms": cuda_ms(lambda: [single(i) for i in range(e)]),
        "plain_ms": cuda_ms(plain, reps=3),
        "library_ms": None if lib is None else cuda_ms(lib),
        "bound_ms": bnd, "bound_by": by, "bytes": nbytes,
        "operations": ops, **(extra or {})}
    log("kernel_case " + json.dumps(case))
    return case


def folded_plane(e, p, dtype, gen, dev="cuda"):
    """E planes ``(E, n, P)`` as one ``(E·n, ld)`` allocation, random."""
    import torch

    from repro_torch.core.plane import aligned_plane

    plane = aligned_plane(e * N_NODES, p, dtype, dev)
    plane.copy_(torch.randn((e * N_NODES, p), generator=gen, device=dev,
                            dtype=torch.float32))
    return plane.unflatten(0, (e, N_NODES))


def grid_matrices(dev="cuda"):
    """Round 0's matrix of each Fig. 4 strategy on BA(33, 2) (``(6, n,
    n)``, fl dense) and the neighbour tables."""
    import numpy as np
    import torch

    from repro_torch.core.coeffs import program_for
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert

    topo = barabasi_albert(N_NODES, 2, 0)
    counts = np.arange(1.0, N_NODES + 1.0)
    mats = []
    for kind in ("fl", "weighted", "unweighted", "random", "degree",
                 "betweenness"):
        program, state = program_for(topo, AggregationStrategy(kind, tau=0.1),
                                     data_counts=counts)
        mats.append(program.matrix(state, 0))
    idx, msk = topo.neighbor_tables()
    return (torch.stack(mats).to(dev), torch.as_tensor(idx, device=dev),
            torch.as_tensor(msk, device=dev))


def check_batched_kernels(gm, dev="cuda", sizes=None):
    """Phase 14 (a): ``gossip_plane`` at the FFN plane with E = 6 and the
    VGG-16 plane with E = 2, ``gossip_edges`` and ``gossip_robust``
    (trimmed, median; a NaN, a +Inf and a −Inf row in experiment 1) at the
    FFN plane with E = 3, all f32, each one launch held to E single
    launches bit for bit."""
    import torch

    from repro_torch.core.mixing import edge_weights

    ffn_p, vgg_p = sizes or (FFN_P, VGG_P)
    c6, idx, msk = grid_matrices(dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    n, b = N_NODES, 4
    cases = []
    for label, e, p in (("ffn", 6, ffn_p), ("vgg16", 2, vgg_p)):
        plane = folded_plane(e, p, torch.float32, gen, dev)
        c = c6[:e].contiguous()
        cases.append(batched_case(
            "gossip_plane", label, e, lambda: gm.gossip_plane(plane, c),
            lambda i: gm.gossip_plane(plane[i], c[i]),
            lambda: gm.gossip_plane_ref(plane, c),
            lambda: torch.matmul(c, plane),
            e * (2 * n * p * b + n * n * 4), 2 * e * n * n * p, plane))
        del plane
        torch.cuda.empty_cache()
    # the on-support strategies: weighted, unweighted, degree
    c3 = c6[[1, 2, 4]].contiguous()
    w = edge_weights(c3, idx, msk)
    dmax = idx.shape[1]
    nnz = int((w != 0).sum())
    plane = folded_plane(3, ffn_p, torch.float32, gen, dev)
    cases.append(batched_case(
        "gossip_edges", "ffn", 3, lambda: gm.gossip_edges(plane, w, idx),
        lambda i: gm.gossip_edges(plane[i], w[i], idx),
        lambda: gm.gossip_edges_ref(plane, w, idx),
        lambda: torch.matmul(c3, plane),
        3 * (2 * n * ffn_p * b + n * dmax * 4) + n * dmax * 4,
        2 * nnz * ffn_p, plane))
    plane[1, 1] = float("nan")
    plane[1, 4, ::3] = float("inf")
    plane[1, 7] = float("-inf")
    for op, k in (("trimmed", 1), ("median", 0)):
        cases.append(batched_case(
            "gossip_robust", "ffn_poisoned", 3,
            lambda: gm.gossip_robust(plane, w, idx, op, k),
            lambda i: gm.gossip_robust(plane[i], w[i], idx, op, k),
            lambda: gm.gossip_robust_ref(plane, w, idx, op, k), None,
            3 * (2 * n * ffn_p * b + n * dmax * 4) + n * dmax * 4,
            sum(robust_operations(w[i], ffn_p, op, k) for i in range(3)),
            plane, {"op": op, "trim_k": k}))
    del plane
    torch.cuda.empty_cache()
    return cases


def sweep_inputs(sc, dev="cuda"):
    """``run_sweep_cells`` keywords that give a grid phase 3's scenario:
    its node split, batches and test sets (``data_fn``) and its init
    (``init_fn``), so each experiment starts where a single-trainer run of
    phases 3, 6 and 13 does."""
    import torch

    from repro_torch.models.paper_models import ffn_init

    def data_fn(dataset, n_nodes, seed, ood_nodes, scale, steps):
        assert (dataset, n_nodes, ood_nodes) == ("mnist", N_NODES,
                                                 (sc["ood"],))
        return sc["batcher"], sc["test_iid"], sc["test_ood"]

    def init_fn(dataset, seed):
        return ffn_init(torch.Generator().manual_seed(0), device=dev)

    return dict(data_fn=data_fn, init_fn=init_fn, device=dev)


class EngineClock:
    """Wall time of each ``SweepEngine.run`` (its set-up and rounds,
    without the grid's host-side build), ended by a synchronize."""

    @staticmethod
    def owner():
        from repro_torch.core.sweep import SweepEngine

        return SweepEngine

    def __enter__(self):
        import torch

        owner = self.owner()
        self.seconds, self._orig = [], owner.run
        outer = self

        def run(obj, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = outer._orig(obj, *args, **kwargs)
            torch.cuda.synchronize()
            outer.seconds.append(time.perf_counter() - t0)
            return res

        owner.run = run
        return self

    def __exit__(self, *exc):
        self.owner().run = self._orig


class TrainerClock(EngineClock):
    """Wall time of each ``DecentralizedTrainer.run`` (the per-round loop
    alone: no data split, no init), ended by a synchronize."""

    @staticmethod
    def owner():
        from repro_torch.core.decentralized import DecentralizedTrainer

        return DecentralizedTrainer


def held_drift(ha, hb, n_eval=512):
    """Per-node drift of two histories in eval samples, on the rounds both
    evaluated."""
    by_round = {m.round: m for m in hb}
    common = [m for m in ha if m.round in by_round]
    assert common
    return max_drift_samples(common, [by_round[m.round] for m in common],
                             n_eval)


def drift_line(label, pairs):
    """Each engine experiment's per-node drift from its single-trainer
    history, in eval samples of 512, held to ``SWEEP_DRIFT_SAMPLES`` on
    the rounds both evaluated (a grid or a single run cut to fewer rounds
    is held on the other's first rounds)."""
    assert pairs, f"{label}: no single-trainer history to hold it to"
    drift = {k: held_drift(a, b) for k, (a, b) in pairs.items()}
    log(f"{label} drift from the single-trainer runs (eval samples of 512, "
        f"limit {SWEEP_DRIFT_SAMPLES}): {json.dumps(drift)}")
    assert max(drift.values()) <= SWEEP_DRIFT_SAMPLES + 1e-3, drift
    return drift


def same_results(a, b, rounds=None):
    """Two sweep results bit for bit: the history (its first ``rounds``
    rounds of ``a``), and the params unless ``rounds`` cuts ``a``."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util

    r = a.rounds if rounds is None else rounds
    for k in ("train_loss", "iid_acc", "ood_acc"):
        assert np.array_equal(getattr(a, k)[:, :r], getattr(b, k),
                              equal_nan=True), k
    if rounds is None:
        for x, y in zip(tree_util.leaves(a.params),
                        tree_util.leaves(b.params)):
            assert torch.equal(x, y)
        for k in (a.analytics or {}):
            assert np.array_equal(a.analytics[k], b.analytics[k]), k


def run_sweep_fig4(sc, gm, dev="cuda", scale=None):
    """Phase 14 (b): Fig. 4 at paper scale as ONE grid — six strategies
    (E = 6, D = 1) on phase 3's scenario through ``run_sweep_cells`` with
    ``mix_impl="pallas"``: one batched ``gossip_plane`` launch a round,
    s/round, each experiment's AUCs and drift from its single-trainer run,
    the device syncs in the run (``set_sync_debug_mode``), peak memory,
    and ``fig4.verdict``."""
    import warnings

    import torch

    from repro_torch.benchmarks import fig4_strategies as fig4
    from repro_torch.benchmarks.common import FULL, run_sweep_cells

    scale = scale or FULL
    cells = fig4.cells(n_nodes=N_NODES)
    results = []
    before = gm.gossip_plane.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with EngineClock() as clock, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rows = run_sweep_cells(cells, scale=scale, mix_impl="pallas",
                                   results=results, **sweep_inputs(sc, dev))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = gm.gossip_plane.launches - before
    assert launches == scale.rounds, launches   # one launch a round
    syncs = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{Path(w.filename).name}:{w.lineno}"
            syncs[where] = syncs.get(where, 0) + 1
    (idxs, result), = results
    secs = clock.seconds[0]
    res = {"experiments": len(cells), "rounds": scale.rounds,
           "s_per_round": secs / scale.rounds, "engine_s": secs,
           "launches": launches, "peak_gb_above_start": peak_gb,
           "syncs": sum(syncs.values()), "syncs_by_line": syncs,
           "aucs": {r["strategy"]: (r["iid_auc"], r["ood_auc"])
                    for r in rows},
           "stream_vs_host_max_dev": max(
               r["analytics"]["stream_vs_host_max_dev"] for r in rows)}
    log("ffn_sweep fig4 grid " + json.dumps(res))
    assert res["stream_vs_host_max_dev"] < 1e-6, res
    log(fig4.verdict(rows))
    drift_line("ffn_sweep fig4", {
        c.strategy: (result.history(e), HISTORIES[c.strategy])
        for e, c in enumerate(cells) if c.strategy in HISTORIES})
    return cells, rows, result


def run_sweep_modes(sc, gm, fig4_run, dev="cuda", scale=None):
    """Phase 14 (c): the same grid chunked (a quarter of its rounds a
    chunk, a checkpoint at each boundary), then resumed from the middle
    checkpoint, each bit for bit the scanned run of (b); and unrolled,
    cut to the middle checkpoint's round, bit for bit the scanned run's
    first rounds and that checkpoint's params.  The middle round must be
    an evaluation round of the scanned run (the unrolled run evaluates
    its last round)."""
    import dataclasses as dc
    import shutil

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.benchmarks.common import FULL, run_sweep_cells
    from repro_torch.kernels import build
    from repro_torch.training.checkpoint import load_checkpoint

    scale = scale or FULL
    cells, _, scanned = fig4_run
    ck = build.BUILD_DIR / "sweep_checkpoints"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(scale=scale, mix_impl="pallas", **sweep_inputs(sc, dev))
    chunk = scale.rounds // 4
    try:
        with EngineClock() as clock:
            out = []
            run_sweep_cells(cells, chunk_rounds=chunk,
                            checkpoint_dir=str(ck), results=out, **kw)
            same_results(scanned, out[0][1])
            files = sorted(p.name for p in ck.iterdir())
            assert len(files) == 3, files
            (ck / files[-1]).unlink()       # resume from the middle one
            out = []
            run_sweep_cells(cells, chunk_rounds=chunk,
                            checkpoint_dir=str(ck), resume=True,
                            results=out, **kw)
            same_results(scanned, out[0][1])
            cut = 2 * chunk
            assert cut % scale.eval_every == 0, (cut, scale.eval_every)
            out = []
            run_sweep_cells(cells, unroll_eval=True, results=out,
                            **dict(kw, scale=dc.replace(scale, rounds=cut)))
            unrolled = out[0][1]
            same_results(scanned, unrolled, rounds=cut)
            state, _, meta = load_checkpoint(str(ck / files[1]),
                                             {"params": unrolled.params})
            assert meta["rounds_done"] == cut, meta
            for x, y in zip(tree_util.leaves(state["params"]),
                            tree_util.leaves(unrolled.params)):
                assert torch.equal(x, y)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    s = clock.seconds
    log("ffn_sweep modes " + json.dumps({
        "chunked_rounds": scale.rounds, "chunk_rounds": chunk,
        "resumed_from_round": 2 * chunk, "unrolled_rounds": cut,
        "chunked_s_per_round": s[0] / scale.rounds,
        "resumed_s_per_round": s[1] / (scale.rounds - 2 * chunk),
        "unrolled_s_per_round": s[2] / cut,
        "bit_identical_to_scanned": True,
        "cut": f"unrolled run and resumed tail cut to {cut} rounds"}))


def run_ffn_sweep(sc, gm):
    """Phase 14 (b) then (c), one main path (``ffn_sweep``), at
    ``FIG4_GRID_ROUNDS`` rounds: phase 18 (a) runs Fig. 4's grid at the
    paper's R = 40."""
    from repro_torch.benchmarks.common import FULL

    reduced_line(14, "ffn_sweep", "rounds", FULL.rounds, FIG4_GRID_ROUNDS)
    scale = dataclasses.replace(FULL, rounds=FIG4_GRID_ROUNDS)
    fig4_run = run_sweep_fig4(sc, gm, scale=scale)
    run_sweep_modes(sc, gm, fig4_run, scale=scale)


def sweep_cut(path):
    """FULL scale cut to ``SWEEP_CUT_ROUNDS`` rounds, printed as a cut."""
    from repro_torch.benchmarks.common import FULL

    reduced_line(14, path, "rounds", FULL.rounds, SWEEP_CUT_ROUNDS)
    return dataclasses.replace(FULL, rounds=SWEEP_CUT_ROUNDS)


def run_sweep_linkfail(sc, gm, dev="cuda", scale=None):
    """Phase 14 (d): ``ablations.run_link_failure``'s grid — unweighted
    and degree at p_fail 0.3, nominal and reactive, ``coeff_mode=
    "program"`` (each round's matrices made in the round loop) through
    batched ``gossip_edges``; the nominal program equal bit for bit to its
    materialized stack; the reactive degree run held by drift to phase
    13's ``ffn_linkfail``.  ``SWEEP_CUT_ROUNDS`` rounds unless ``scale``
    says otherwise."""
    from repro_torch.benchmarks import ablations
    from repro_torch.benchmarks.common import linkfail_cells, run_sweep_cells

    scale = scale or sweep_cut("ffn_sweep_linkfail")
    before = gm.gossip_edges.launches
    kw = dict(mix_impl="edges", **sweep_inputs(sc, dev))
    out = {}
    with EngineClock() as clock:
        for reactive in (False, True):
            res = []
            rows = ablations.run_link_failure(
                p_fails=(0.3,), scale=scale, n_nodes=N_NODES,
                reactive=reactive, log=lambda *a: None, results=res, **kw)
            out[reactive] = (rows, res[0][1])
            log(f"ffn_sweep_linkfail reactive={reactive} " + json.dumps({
                r["strategy"]: (r["iid_auc"], r["ood_auc"]) for r in rows}))
        stack = []
        run_sweep_cells(linkfail_cells(n_nodes=N_NODES, p_fails=(0.3,),
                                       reactive=False),
                        scale=scale, coeff_mode="stack", results=stack, **kw)
    same_results(out[False][1], stack[0][1])
    launches = gm.gossip_edges.launches - before
    assert launches == 3 * scale.rounds, launches
    log("ffn_sweep_linkfail " + json.dumps({
        "s_per_round": [s / scale.rounds for s in clock.seconds],
        "launches": launches,
        "program_equals_stack": "bit for bit (nominal)"}))
    pairs = {}
    for reactive in (False, True):
        key = f"linkfail_{reactive}"
        if key in HISTORIES:
            pairs[f"degree_{'reactive' if reactive else 'nominal'}"] = (
                out[reactive][1].history(1), HISTORIES[key])
    drift_line("ffn_sweep_linkfail", pairs)
    return out


def run_sweep_byzantine(sc, gm, dev="cuda", scale=None):
    """Phase 14 (e): ``byzantine_cells`` at fault rates 0, 0.1, 0.2 on
    BA(33, 2) with the OOD data on the hub, the trimmed mean through
    batched ``gossip_robust``: ``"noise"`` faults with the quarantine
    screen, then a ``"nan"`` group with ``skip_nonfinite_updates(sgd)``;
    the quarantine digests and skipped-step counts; the rate-0 experiment
    held by drift to phase 6's trimmed run.  ``SWEEP_CUT_ROUNDS`` rounds
    unless ``scale`` says otherwise."""
    import numpy as np

    from repro_torch.benchmarks.common import byzantine_cells, \
        run_sweep_cells
    from repro_torch.core.dynamic import FaultSpec
    from repro_torch.core.topology import barabasi_albert

    scale = scale or sweep_cut("ffn_sweep_byzantine")
    ba = barabasi_albert(N_NODES, 2, 0).name
    cells = [c for c in byzantine_cells(n_nodes=N_NODES,
                                        rates=(0.0, 0.1, 0.2),
                                        robusts=("trimmed",))
             if c.topo.name == ba and c.ood_k == 1]
    assert [c.fault_rate for c in cells] == [0.0, 0.1, 0.2]
    before = gm.gossip_robust.launches
    kw = dict(scale=scale, mix_impl="edges", **sweep_inputs(sc, dev))
    groups = {}
    with EngineClock() as clock:
        for label, spec, guard in (
                ("noise", FaultSpec(mode="noise", quarantine=True), False),
                ("nan", FaultSpec(mode="nan"), True)):
            res = []
            rows = run_sweep_cells(cells, fault=spec, skip_nonfinite=guard,
                                   results=res, **kw)
            result = res[0][1]
            groups[label] = result
            skipped = (result.opt_state["skipped"].sum(dim=1).tolist()
                       if guard else None)
            log(f"ffn_sweep_byzantine {label} " + json.dumps({
                "rates": [c.fault_rate for c in cells],
                "aucs": [(r["iid_auc"], r["ood_auc"]) for r in rows],
                "quarantine": [r["fault"] for r in rows],
                "skipped_steps": skipped,
                "finite_params": all_finite(result.params)}))
    launches = gm.gossip_robust.launches - before
    assert launches == 2 * scale.rounds, launches
    same_rate0 = all(np.array_equal(getattr(groups["noise"], k)[0],
                                    getattr(groups["nan"], k)[0])
                     for k in ("train_loss", "iid_acc", "ood_acc"))
    log("ffn_sweep_byzantine " + json.dumps({
        "s_per_round": [s / scale.rounds for s in clock.seconds],
        "launches": launches,
        "rate0_noise_group_equals_rate0_nan_group": same_rate0}))
    if "robust_trimmed" in HISTORIES:
        drift_line("ffn_sweep_byzantine rate 0", {
            "noise_group": (groups["noise"].history(0),
                            HISTORIES["robust_trimmed"])})
    return groups


# ----------------------------------------------------------------------
# phase 15: GPT-2 on TinyMem, the paper's third model
# ----------------------------------------------------------------------
GPT2_P = 7_107_072            # parameters a node (the reference's tree)
GPT2_ROUNDS = 2               # (a): two rounds at FULL scale
GPT2_SWEEP_ROUNDS = 2         # (b)
GPT2_SWEEP_EPOCHS = 1         # (b): one of FULL's 5 local epochs a round
GPT2_STEP_NODES, GPT2_STEP_MICRO, GPT2_STEP_STEPS = 8, 2, 4   # (c)
GPT2_BUDGET_S = 180
# per-node drift of a (b) experiment from its single-trainer run, in eval
# targets (max over nodes, rounds and both test sets).  Measured on the
# H100: 0 for both strategies (the grid's LocalTrain takes 42 + 24 of its
# 66 folded nodes a call, the single runs 33; no accuracy moved); pinned
# there
GPT2_DRIFT_TARGETS = 0


def gpt2_setup(local_epochs=5):
    """FULL-scale TinyMem on BA(33, 2), the language backdoor on the hub:
    ``benchmarks.common.cell_data``'s node split, batches and test sets
    (the OOD set with its trigger mask), the steps from the median
    node."""
    import dataclasses as dc

    from repro_torch.benchmarks.common import FULL, cell_data
    from repro_torch.core.topology import barabasi_albert

    topo = barabasi_albert(N_NODES, 2, 0)
    ood = topo.kth_highest_degree_node(1)
    scale = dc.replace(FULL, local_epochs=local_epochs)
    batcher, test_iid, test_ood = cell_data("tinymem", N_NODES, 0, (ood,),
                                            scale, 0)
    return dict(topo=topo, ood=ood, batcher=batcher, test_iid=test_iid,
                test_ood=test_ood, scale=scale)


def gpt2_fns():
    from repro_torch.models.paper_models import (
        gpt2_tinymem_config,
        lm_accuracy,
        lm_loss,
    )
    from repro_torch.training.optimizer import adam

    cfg = gpt2_tinymem_config()
    return cfg, lm_loss(cfg), lm_accuracy(cfg), adam(1e-3)


def gpt2_init(dev="cuda"):
    """One node's GPT-2-TinyMem init, drawn on the card from seed 0."""
    import torch

    from repro_torch.models.transformer import init_params

    return init_params(torch.Generator(device=dev).manual_seed(0),
                       gpt2_fns()[0])


def gpt2_trainer(sc, strategy, rounds, local_epochs, dev="cuda"):
    from repro_torch.core.decentralized import (
        DecentralizedConfig,
        DecentralizedTrainer,
    )
    from repro_torch.core.strategies import AggregationStrategy

    _, loss, acc, opt = gpt2_fns()
    return DecentralizedTrainer(
        sc["topo"], AggregationStrategy(strategy, tau=0.1), opt, loss, acc,
        DecentralizedConfig(rounds=rounds, local_epochs=local_epochs,
                            eval_every=1, mix_impl="pallas"),
        data_counts=sc["batcher"].data_counts(), device=dev)


def gpt2_targets(batch) -> float:
    """The eval targets an LM accuracy counts: the masked ones, or every
    next-token target without a mask."""
    toks = batch["tokens"]
    if "mask" in batch:
        return float(batch["mask"].sum())
    return float(toks.shape[0] * (toks.shape[1] - 1))


def gpt2_drift(ha, hb, sc) -> float:
    """Max per-node accuracy drift between two histories, in eval targets
    (each test set's count)."""
    counts = {"iid_acc": gpt2_targets(sc["test_iid"]),
              "ood_acc": gpt2_targets(sc["test_ood"])}
    return max(float(abs(getattr(a, k) - getattr(b, k)).max()) * n
               for a, b in zip(ha, hb) for k, n in counts.items())


def gpt2_history_line(hist):
    return [{"round": m.round, "loss": float(m.train_loss.mean()),
             "iid": float(m.iid_acc.mean()), "ood": float(m.ood_acc.mean()),
             "ood_max_node": float(m.ood_acc.max())}
            for m in hist]


def gpt2_slices(sc, rows, dev="cuda"):
    """Nodes a vmapped call takes under the card's node budget: a
    LocalTrain step's gradients and an evaluation."""
    from repro_torch.core.decentralized import node_budget, slice_rows

    _, loss, acc, _ = gpt2_fns()
    budget = node_budget(dev)
    step = {"tokens": sc["test_iid"]["tokens"][:sc["batcher"].batch_size]}
    return {"train_nodes_a_call": slice_rows(loss, step, rows, budget,
                                             N_NODES),
            "eval_nodes_a_call": slice_rows(acc, sc["test_iid"], rows,
                                            budget),
            "node_budget_gb": budget / 1e9}


def check_gpt2_plane(gm, dev="cuda", p=GPT2_P):
    """The GPT-2 plane through ``stream_kernel``: ``gossip_plane`` at (33,
    P) f32 against its plain version, and batched at E = 2 (Fig. 4's pair
    of matrices) against its plain version and its two single launches;
    CUDA-event medians beside the byte bound, one ``torch.matmul`` and one
    ``copy_`` of the plane's bytes."""
    import torch

    from repro_torch.core.plane import aligned_plane

    c6, _, _ = grid_matrices(dev)
    c2 = c6[[2, 4]].contiguous()              # unweighted, degree
    gen = torch.Generator(device=dev).manual_seed(15)
    n, b = N_NODES, 4
    cases = []
    single = aligned_plane(n, p, torch.float32, dev)
    single.copy_(torch.randn((n, p), generator=gen, device=dev))
    planes = (("gpt2_tinymem", single, c2[1]),
              ("gpt2_tinymem_batched", folded_plane(2, p, torch.float32, gen,
                                                    dev), c2))
    for label, plane, c in planes:
        e = 1 if c.ndim == 2 else c.shape[0]
        run = lambda: gm.gossip_plane(plane, c)
        plain = lambda: gm.gossip_plane_ref(plane, c)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        assert err <= tol, (label, err, tol)
        extra = {}
        if e > 1:
            singles = torch.stack([gm.gossip_plane(plane[i], c[i])
                                   for i in range(e)])
            assert exact_err(out, singles) == 0.0, label
            extra["singles_ms"] = cuda_ms(
                lambda: [gm.gossip_plane(plane[i], c[i]) for i in range(e)])
            del singles
        del out, ref
        nbytes = e * (2 * n * p * b + n * n * 4)
        flops = 2 * e * n * n * p
        bnd, by = bound_ms(nbytes, flops)
        case = {"name": "gossip_plane", "plane": label,
                "shape": ([e] if e > 1 else []) + [n, p], "dtype": "float32",
                "experiments": e, "main": False, "max_abs_err": err,
                "tolerance": f"<= 1e-5*max|ref| = {tol:.3g}",
                "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=3),
                "library_ms": cuda_ms(lambda: torch.matmul(c, plane)),
                "copy_ms": copy_ms(plane), "bound_ms": bnd, "bound_by": by,
                "bytes": nbytes, "flops": flops, **extra}
        log("kernel_case " + json.dumps(case))
        cases.append(case)
        del plane
    del single, planes
    torch.cuda.empty_cache()
    return cases


def run_gpt2_round(sc, gm, dev="cuda"):
    """Phase 15 (a): Algorithm 1 with GPT-2 on TinyMem at FULL scale
    (BA(33, 2), the backdoor on the hub, ``degree``, the fused plane), two
    rounds: s/round, each round's LocalTrain + mix on the card, peak
    memory, the history."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core.decentralized import stack_params

    n_steps = sc["batcher"].local_epochs * sc["batcher"].steps
    log("reduced " + json.dumps({
        "phase": 15, "path": "gpt2_round", "what": "rounds",
        "from": 40, "to": GPT2_ROUNDS}))
    tr = gpt2_trainer(sc, "degree", GPT2_ROUNDS, sc["batcher"].local_epochs,
                      dev)
    params = stack_params([gpt2_init(dev)] * N_NODES)
    assert sum(x[0].numel() for x in tree_util.leaves(params)) == GPT2_P
    round_fn, round_s = tr._round_fn, []

    def timed_round(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = round_fn(*args)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return out

    tr._round_fn = timed_round
    before = gm.gossip_plane.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, hist = tr.run(params, sc["batcher"].round_batches, sc["test_iid"],
                     sc["test_ood"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = gm.gossip_plane.launches - before
    assert launches == GPT2_ROUNDS, launches       # one launch a mix
    for m in hist:
        assert np.all(np.isfinite(m.train_loss)), m.round
    losses = [float(m.train_loss.mean()) for m in hist]
    assert losses[1] < losses[0], losses
    HISTORIES["gpt2_degree_full"] = hist
    res = {"rounds": GPT2_ROUNDS, "local_steps_per_round": n_steps,
           "s_per_round": secs / GPT2_ROUNDS,
           "round_fn_s": round_s, "s_per_local_step": [
               s / n_steps for s in round_s],
           "peak_gb": peak_gb, "launches": launches,
           **gpt2_slices(sc, N_NODES, dev),
           "history": gpt2_history_line(hist)}
    log("gpt2_round " + json.dumps(res))
    return res


def run_gpt2_sweep(sc, gm, dev="cuda"):
    """Phase 15 (b): Fig. 4's pair (unweighted, degree) on TinyMem as one
    sweep-engine grid (E = 2) with the bank on the card and one batched
    ``gossip_plane`` launch a round, cut to ``GPT2_SWEEP_ROUNDS`` rounds of
    ``GPT2_SWEEP_EPOCHS`` local epoch: s/round, the syncs in the round
    loop (0), peak memory, per-round accuracies, and each experiment's
    drift from a single-trainer run of the same cell and cut."""
    import dataclasses as dc
    import warnings

    import torch

    from repro_torch.benchmarks import fig4_strategies as fig4
    from repro_torch.benchmarks.common import run_sweep_cells
    from repro_torch.core import sweep
    from repro_torch.core.decentralized import stack_params

    for what, full, cut in (("rounds", 40, GPT2_SWEEP_ROUNDS),
                            ("local epochs", 5, GPT2_SWEEP_EPOCHS)):
        log("reduced " + json.dumps({"phase": 15, "path": "gpt2_sweep",
                                     "what": what, "from": full, "to": cut}))
    scale = dc.replace(sc["scale"], rounds=GPT2_SWEEP_ROUNDS, eval_every=1)
    cells = [c for c in fig4.cells(datasets=("tinymem",), n_nodes=N_NODES)
             if c.strategy in ("unweighted", "degree")]
    assert [c.strategy for c in cells] == ["unweighted", "degree"]

    def data_fn(dataset, n_nodes, seed, ood_nodes, scale_, steps):
        assert (dataset, n_nodes, ood_nodes) == ("tinymem", N_NODES,
                                                 (sc["ood"],))
        return sc["batcher"], sc["test_iid"], sc["test_ood"]

    singles = {}
    for c in cells:
        tr = gpt2_trainer(sc, c.strategy, GPT2_SWEEP_ROUNDS,
                          GPT2_SWEEP_EPOCHS, dev)
        singles[c.strategy] = tr.run(
            stack_params([gpt2_init(dev)] * N_NODES),
            sc["batcher"].round_batches, sc["test_iid"], sc["test_ood"])[1]
    # the syncs inside the round loop: warnings between entering and
    # leaving make_scan_fn's loop
    make_scan, window = sweep.make_scan_fn, []

    def counting_make_scan(*a, **k):
        scan = make_scan(*a, **k)

        def run(*args, **kwargs):
            window.append(len(caught))
            out = scan(*args, **kwargs)
            window.append(len(caught))
            return out
        return run

    results = []
    before = gm.gossip_plane.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sweep.make_scan_fn = counting_make_scan
    try:
        with EngineClock() as clock, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rows = run_sweep_cells(
                    cells, scale=scale, mix_impl="pallas", results=results,
                    data_fn=data_fn, init_fn=lambda ds, seed: gpt2_init(dev),
                    device=dev)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        sweep.make_scan_fn = make_scan
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = gm.gossip_plane.launches - before
    assert launches == GPT2_SWEEP_ROUNDS, launches   # one launch a round
    shapes = gm.gossip_plane.shapes
    assert shapes[("E=2", N_NODES, GPT2_P, "float32")] == launches, shapes
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    a, b = window
    in_loop = [w for w in caught[a:b] if "synchroniz" in str(w.message)]
    assert not in_loop, [f"{Path(w.filename).name}:{w.lineno}"
                         for w in in_loop]
    (idxs, result), = results
    n_steps = GPT2_SWEEP_EPOCHS * sc["batcher"].steps
    secs = clock.seconds[0]
    res = {"experiments": len(cells), "rounds": GPT2_SWEEP_ROUNDS,
           "local_steps_per_round": n_steps,
           "s_per_round": secs / GPT2_SWEEP_ROUNDS, "engine_s": secs,
           "s_per_local_step": secs / (GPT2_SWEEP_ROUNDS * n_steps),
           "launches": launches, "peak_gb_above_start": peak_gb,
           "syncs": len(syncs), "syncs_in_round_loop": len(in_loop),
           **gpt2_slices(sc, len(cells) * N_NODES, dev),
           "history": {c.strategy: gpt2_history_line(result.history(e))
                       for e, c in enumerate(cells)},
           "aucs": {r["strategy"]: (r["iid_auc"], r["ood_auc"])
                    for r in rows}}
    log("gpt2_sweep grid " + json.dumps(res))
    drift = {c.strategy: gpt2_drift(result.history(e), singles[c.strategy],
                                    sc)
             for e, c in enumerate(cells)}
    log(f"gpt2_sweep drift from the single-trainer runs (eval targets of "
        f"{gpt2_targets(sc['test_iid']):.0f} IID and "
        f"{gpt2_targets(sc['test_ood']):.0f} OOD, limit "
        f"{GPT2_DRIFT_TARGETS}): {json.dumps(drift)}")
    assert max(drift.values()) <= GPT2_DRIFT_TARGETS + 1e-3, drift
    return res


def run_gpt2_train_step(dev="cuda"):
    """Phase 15 (c): the production train step on the GPT-2-TinyMem
    config at n = 8, microbatch 2, AdamW on a warmup-cosine schedule
    behind the nonfinite guard, batches from ``lm_token_stream``, gossip
    by BA(8, 2)'s degree matrix: every loss finite."""
    import math

    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.decentralized import round_coeffs, stack_params
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.data.pipeline import lm_token_stream
    from repro_torch.training.optimizer import (make_optimizer,
                                                warmup_cosine_schedule)
    from repro_torch.training.train_step import (make_train_step,
                                                 reshape_for_microbatch)

    cfg = gpt2_fns()[0]
    n, micro, steps = GPT2_STEP_NODES, GPT2_STEP_MICRO, GPT2_STEP_STEPS
    opt = make_optimizer("adamw", warmup_cosine_schedule(1e-3, 2, steps),
                         skip_nonfinite=True)
    step = make_train_step(cfg, ParallelConfig(n_nodes=n, microbatch=micro),
                           opt)
    params = stack_params([gpt2_init(dev)] * n)
    state = opt.init(params)
    coeffs = torch.as_tensor(round_coeffs(
        barabasi_albert(n, 2, 0), AggregationStrategy("degree"), 0),
        device=dev)
    stream = lm_token_stream(cfg.vocab_size, 150, n * micro * 4, seed=0)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = reshape_for_microbatch(
            {k: torch.as_tensor(v, device=dev) for k, v in
             next(stream).items()}, n, micro)
        params, state, loss = step(params, state, batch, coeffs)
        losses.append(float(loss))
    secs = time.perf_counter() - t0
    assert all(math.isfinite(x) for x in losses), losses
    skipped = state["skipped"].tolist()
    assert skipped == [0] * n, skipped
    log("gpt2_train_step " + json.dumps({
        "nodes": n, "microbatch": micro, "local_batch": micro * 4,
        "seq": 150, "steps": steps, "losses": losses,
        "s_per_step": secs / steps, "skipped": skipped}))
    return losses


def run_gpt2(gm, dev="cuda"):
    """Phase 15, one main path (``gpt2_tinymem``): (a), (b), (c)."""
    t0 = time.perf_counter()
    sc = gpt2_setup()
    log(f"gpt2 setup (TinyMem {sc['scale'].n_train} + "
        f"{sc['scale'].n_test}, the node split, the test batches): "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sc['batcher'].steps} steps an epoch, IID targets "
        f"{gpt2_targets(sc['test_iid']):.0f}, OOD masked targets "
        f"{gpt2_targets(sc['test_ood']):.0f}")
    out = {"round": run_gpt2_round(sc, gm, dev)}
    cut = gpt2_setup(GPT2_SWEEP_EPOCHS)
    out["sweep"] = run_gpt2_sweep(cut, gm, dev)
    out["train_step"] = run_gpt2_train_step(dev)
    out["sc"] = sc
    return out


# ----------------------------------------------------------------------
# phase 2, flash attention: the kernel against its plain version
# ----------------------------------------------------------------------
FLASH_CASES = (
    # (label, (B, S, H, KV, hd), dtype, window, softcap, main)
    ("stablelm_prefill", (4, 4096, 32, 32, 64), "bfloat16", 0, 0.0, True),
    ("stablelm_prefill", (4, 4096, 32, 32, 64), "float32", 0, 0.0, False),
    ("gemma2_local", (1, 8192, 32, 16, 128), "bfloat16", 4096, 50.0, False),
    ("gemma2_global", (1, 8192, 32, 16, 128), "bfloat16", 0, 50.0, False),
    ("ragged", (2, 1000, 8, 2, 64), "float32", 256, 50.0, False),
    ("ragged", (2, 1000, 8, 2, 64), "bfloat16", 256, 50.0, False),
    # llama4-scout's prefill in phase 16: 40 query heads over 8 (a group
    # of 5), hd 128, the fleet's n·B = 4 sequences of 64
    ("llama4_prefill", (4, 64, 40, 8, 128), "bfloat16", 0, 0.0, False),
    # hymba-1.5b's prefill in phase 17 (b): 25 query heads over 5 (a
    # group of 5), hd 64, the fleet's n·B = 4 sequences of 4096; its local
    # layers see a window of 1024, its global ones all
    ("hymba_local", (4, 4096, 25, 5, 64), "bfloat16", 1024, 0.0, False),
    ("hymba_global", (4, 4096, 25, 5, 64), "bfloat16", 0, 0.0, False),
    # the frontends' (2, 4096) prefills in phase 17 (g): internvl2-1b's
    # 14 query heads over 2 (a group of 7), musicgen-medium's 24 over 24
    ("internvl2_prefill", (2, 4096, 14, 2, 64), "bfloat16", 0, 0.0, False),
    ("musicgen_prefill", (2, 4096, 24, 24, 64), "bfloat16", 0, 0.0, False),
    # phi3-mini-3.8b's prefill in phase 18 (c): hd 3072 / 32 = 96, the
    # fleet's n·B = 4 sequences of 4096; and a ragged hd-96 case
    ("phi3_prefill", (4, 4096, 32, 32, 96), "bfloat16", 0, 0.0, False),
    ("ragged_hd96", (3, 1000, 8, 2, 96), "float32", 0, 0.0, False),
    ("ragged_hd96", (3, 1000, 8, 2, 96), "bfloat16", 0, 0.0, False),
)
FLASH_F32_TOL = 2e-5    # times max|ref|


def unmasked_pairs(s, window):
    """(query, key) pairs a causal row set keeps: min(s + 1, window)."""
    if window <= 0:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


LIBRARY_REL_TOL = 1e-2  # the yardstick computes the same function


def flex_call(qt, kt, vt, window, cap):
    """The library call computing what the kernel computes where SDPA
    cannot (a logit softcap): ``flex_attention``, compiled once per shape,
    on (B, H, S, hd) inputs, with ``c·tanh(l/c)`` as its score mod, the
    causal (and window) mask as its block mask, and GQA through
    ``enable_gqa``.  Returns the call; the block mask is built outside it."""
    import torch
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )

    global _FLEX
    if _FLEX is None:
        _FLEX = torch.compile(flex_attention, dynamic=False)
    s = qt.shape[2]

    def keep(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx
        return ok & (q_idx - kv_idx < window) if window > 0 else ok

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(keep, None, None, s, s, device=qt.device)
    return lambda: _FLEX(qt, kt, vt, score_mod=score_mod if cap else None,
                         block_mask=mask, enable_gqa=kt.shape[1] != qt.shape[1])


_FLEX = None


def library_check(lib_out, ref, name):
    """The library call's output (B, H, S, hd) against the plain version
    (B, S, H, hd): relative Frobenius error, gated at LIBRARY_REL_TOL so
    the yardstick is known to compute the same function (a wrong mask is
    tens of percent off; bf16 rounding is a few tenths of one)."""
    rel = float((lib_out.transpose(1, 2).float() - ref.float()).norm()
                / ref.float().norm())
    assert rel <= LIBRARY_REL_TOL, (name, rel)
    return rel


def check_flash(dev):
    """``flash_attention`` against ``flash_attention_ref`` at the serving
    path's shapes.  Gates: f32 max abs err <= 2e-5 max|ref|; bf16
    elementwise within one bf16 ulp of the plain version's output beyond
    that same f32 bound (each side rounds its own f32 value once); every
    output finite.  SDPA is the library yardstick where no softcap
    applies (``is_causal``, or a boolean window mask), ``flex_attention``
    where one does.  The
    bound takes bf16 cases (the tensor-core kernel) at the bf16
    tensor-core peak and f32 cases (the CUDA-core kernel) at the f32 one;
    ``achieved_tflops`` is the function's flops over the kernel's time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for label, (b, s, h, kv, hd), dt, window, cap, main in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, s, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)))
        run = lambda: fa.flash_attention(q, k, v, window=window,
                                         logit_softcap=cap)
        plain = lambda: fa.flash_attention_ref(q, k, v, window=window,
                                               logit_softcap=cap)
        out, ref = run().float(), plain().float()
        torch.cuda.synchronize()
        assert out.shape == (b, s, h, hd) and bool(torch.isfinite(out).all())
        err = (out - ref).abs()
        max_err = float(err.max())
        f32_tol = FLASH_F32_TOL * float(ref.abs().max())
        if dtype == torch.float32:
            ok = max_err <= f32_tol
            tol_txt = f"<= 2e-5*max|ref| = {f32_tol:.3g}"
            over_ulp, gate_use = None, max_err / f32_tol
        else:
            ulp = bf16_ulp(ref)
            ok = bool((err <= ulp + f32_tol).all())
            tol_txt = "<= 1 bf16 ulp + 2e-5*max|ref| elementwise"
            over_ulp = int((err > ulp).sum())
            gate_use = float((err / (ulp + f32_tol)).max())
        del out, err
        assert ok, f"flash_attention {label} {dt}: {max_err} {tol_txt}"
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if cap == 0.0:
            # no cap: SDPA, causal, or with the window as a boolean mask
            mask = None
            if window > 0:
                i = torch.arange(s, device=dev)
                mask = (i[None] <= i[:, None]) & (i[:, None] - i[None]
                                                  < window)
            library, lib_name = (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=kv != h)), "sdpa" if mask is None else "sdpa_mask"
        else:
            library, lib_name = flex_call(qt, kt, vt, window, cap), "flex"
        lib_err = library_check(library(), ref, lib_name)
        del ref
        library_ms = cuda_ms(library)
        del qt, kt, vt, library
        pairs = unmasked_pairs(s, window)
        nbytes = (2 * b * s * h * hd + 2 * b * s * kv * hd) * q.element_size()
        flops = 4 * hd * h * b * pairs
        peak = (BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16
                else F32_FLOPS_PER_S)
        bnd, by = bound_ms(nbytes, flops, peak)
        ms = cuda_ms(run, reps=10)
        case = {
            "name": "flash_attention", "case": label, "shape": [b, s, h, kv, hd],
            "dtype": dt, "window": window, "softcap": cap, "main": main,
            "max_abs_err": max_err, "tolerance": tol_txt,
            "elements_beyond_one_ulp": over_ulp,
            "max_err_over_gate": gate_use,
            "ms": ms, "plain_ms": cuda_ms(plain, reps=3),
            "library_ms": library_ms, "library": lib_name,
            "library_rel_err": lib_err, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "flops": flops, "unmasked_pairs": pairs,
            "peak_flops": peak, "achieved_tflops": flops / ms / 1e9,
        }
        log("kernel_case " + json.dumps(case))
        cases.append(case)
        del q, k, v
        torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------
# phase 2, the RWKV-6 scan: the kernel against its plain version
# ----------------------------------------------------------------------
RWKV_CASES = (
    # (label, (B, S, H, hd), dtype, initial state, strided, main)
    ("rwkv6_prefill", (2, 4096, 40, 64), "bfloat16", "zero", False, True),
    ("rwkv6_prefill", (2, 4096, 40, 64), "bfloat16", "random", False, False),
    ("rwkv6_prefill", (2, 4096, 40, 64), "float32", "random", False, False),
    ("ragged_strided", (3, 1000, 4, 64), "bfloat16", "random", True, False),
    ("hd32", (2, 2048, 8, 32), "float32", "random", False, False),
)
# times max|ref|, for f32 y and every final state: pinned from the first
# run on an H100 SXM (700 W), which measured at most 1.96e-7 (f32 y
# 1.8e-7, states 2.0e-7); there bf16 y came to at most 99.94% of its gate
# (one ulp), 191 of 21 M outputs more than one ulp off by less than the
# f32 bound
RWKV_F32_TOL = 1e-6
RWKV_LIBRARY = "none: no PyTorch call computes the RWKV-6 recurrence"


def rwkv_inputs(gen, dev, b, s, h, hd, dtype, state, strided):
    """r, k, v ~ N(0, 0.5²) in ``dtype`` (strided: slices of one fused
    (B, S, 3H, hd) tensor); decays w = exp(-exp(x)), x uniform in [-6, 0]
    (w from 0.37 to 0.9975: short and long memory); u ~ N(0, 0.3²); the
    initial state zero or ~ N(0, 0.1²)."""
    import torch

    normal = lambda shape, scale: torch.randn(
        shape, generator=gen, device=dev).mul_(scale)
    if strided:
        fused = normal((b, s, 3 * h, hd), 0.5).to(dtype)
        r, k, v = fused[:, :, :h], fused[:, :, h:2 * h], fused[:, :, 2 * h:]
    else:
        r, k, v = (normal((b, s, h, hd), 0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((b, s, h, hd), generator=gen,
                                        device=dev) * 6 - 6))
    u = normal((h, hd), 0.3)
    st = (torch.zeros((b, h, hd, hd), device=dev) if state == "zero"
          else normal((b, h, hd, hd), 0.1))
    return r, k, v, w, u, st


def check_rwkv(dev):
    """``rwkv_scan`` against ``rwkv_scan_ref`` at the serving path's
    shapes.  Gates: f32 y and every final state within RWKV_F32_TOL of
    max|ref| (another summation order); bf16 y elementwise within one
    bf16 ulp of the plain version's beyond that bound (each rounds its own
    f32 value once); every output finite."""
    import torch

    from repro_torch.kernels import ssm_scan as ts

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for label, (b, s, h, hd), dt, state, strided, main in RWKV_CASES:
        dtype = getattr(torch, dt)
        x = rwkv_inputs(gen, dev, b, s, h, hd, dtype, state, strided)
        run = lambda: ts.rwkv_scan(*x)
        plain = lambda: ts.rwkv_scan_ref(*x)
        (y, sf), (yr, sr) = run(), plain()
        torch.cuda.synchronize()
        assert y.shape == (b, s, h, hd) and bool(torch.isfinite(y).all()) \
            and bool(torch.isfinite(sf).all())
        y, yr = y.float(), yr.float()
        err = (y - yr).abs()
        max_err = float(err.max())
        y_tol = RWKV_F32_TOL * float(yr.abs().max())
        state_err = float((sf - sr).abs().max())
        state_tol = RWKV_F32_TOL * float(sr.abs().max())
        if dtype == torch.float32:
            ok = max_err <= y_tol
            tol_txt = f"<= {RWKV_F32_TOL:g}*max|ref| = {y_tol:.3g}"
            over_ulp, gate_use = None, max_err / y_tol
        else:
            ulp = bf16_ulp(yr)
            ok = bool((err <= ulp + y_tol).all())
            tol_txt = (f"<= 1 bf16 ulp + {RWKV_F32_TOL:g}*max|ref| "
                       f"elementwise")
            over_ulp = int((err > ulp).sum())
            gate_use = float((err / (ulp + y_tol)).max())
        del y, yr, sf, sr, err
        assert ok, f"rwkv_scan {label} {dt}: {max_err} {tol_txt}"
        assert state_err <= state_tol, (label, dt, state_err, state_tol)
        n_elem = b * s * h * hd
        nbytes = (4 * n_elem * x[0].element_size() + 4 * n_elem
                  + 2 * b * h * hd * hd * 4 + h * hd * 4)
        flops = 4 * b * s * h * hd * hd
        bnd, by = bound_ms(nbytes, flops)
        case = {
            "name": "rwkv_scan", "case": label, "shape": [b, s, h, hd],
            "dtype": dt, "initial_state": state, "strided": strided,
            "main": main, "max_abs_err": max_err, "tolerance": tol_txt,
            "elements_beyond_one_ulp": over_ulp,
            "max_err_over_gate": gate_use, "state_max_abs_err": state_err,
            "state_err_over_gate": state_err / state_tol,
            "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=3),
            "library_ms": None, "library": RWKV_LIBRARY,
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes, "flops": flops,
        }
        log("kernel_case " + json.dumps(case))
        # k * v, the y FMA and the state FMA: 3 lane instructions an
        # element and step (the bonus a_t is formed once a step and head)
        issue_floor("rwkv_scan", f"{label} {dt}", 3 * b * s * h * hd * hd,
                    "fmul+2 fma an element-step")
        cases.append(case)
        del x
        torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------
# phase 2, MLA latent attention: the kernel against its plain version
# ----------------------------------------------------------------------
MLA_CASES = (
    # (label, (B, S, H, r, dr), T, q/out dtype, c_kv/k_rope dtype, strided,
    #  main)
    ("deepseek_prefill", (4, 4096, 128, 512, 64), 4096, "float32",
     "bfloat16", False, True),
    ("deepseek_prefill", (4, 4096, 128, 512, 64), 4096, "float32", "float32",
     False, False),
    ("ragged_strided", (3, 1000, 16, 512, 64), 1000, "float32", "bfloat16",
     True, False),
    ("smoke", (2, 256, 4, 32, 16), 256, "float32", "float32", False, False),
    ("t_ne_s", (2, 1024, 16, 512, 64), 600, "bfloat16", "bfloat16", False,
     False),
)
# times max|ref|, for f32 outputs (another summation order; bf16 outputs
# one bf16 ulp beyond it): pinned from the first full run on an H100 SXM
# (700 W), which measured f32 outputs at most 3.7e-6 of max|ref| (18% of
# the gate) and the all-bf16 T != S case at 99.1% of its gate (761 of
# 19 M outputs more than one ulp off, by less than this bound)
MLA_F32_TOL = 2e-5


def mla_pairs(s, t):
    """(query, latent row) pairs a causal sequence keeps: t <= s, t < T."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def mla_modeled_l2_bytes(b, s, t, h, r, dr, rows, keys):
    """A model, not a measurement: the bf16 latent bytes that
    ``mla_tc_kernel``'s blocks stage from L2 into shared memory, each
    block (b, h, ``rows`` query rows) staging every ``keys``-row tile its
    rows can see (t < T).  ``rows`` and ``keys`` come from the built
    kernel (``tc_tiles``)."""
    streamed = 0
    for q0 in range(0, s, rows):
        tiles = -(-min(t, q0 + rows) // keys)
        streamed += min(t, tiles * keys)
    return b * h * streamed * (r + dr) * 2


def sdpa_backend(q, k, v):
    """The first SDPA backend that computes the yardstick on these inputs
    (flash, cuDNN, memory-efficient), or "math"."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(q[:, :, :8], k[:, :, :8],
                                               v[:, :, :8], is_causal=True,
                                               scale=1.0)
            return be
        except RuntimeError:
            continue
    return SDPBackend.MATH


def mla_library(ql, qr, ck, kr):
    """The library yardstick: one SDPA call with q = [q_lat || q_rope]
    (576 wide), k = [c_kv || k_rope] as one kv head shared by all heads
    (expanded, stride 0), v = c_kv and scale 1, causal; in q's type (SDPA
    takes one type for q, k and v).  Returns (the call, the backend's
    name); the math backend runs one sequence at a time, as it holds the
    whole (H, S, T) logits."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    h = ql.shape[2]
    q = torch.cat([ql, qr], -1).transpose(1, 2)
    k = torch.cat([ck, kr], -1).to(ql.dtype)[:, None].expand(-1, h, -1, -1)
    v = ck.to(ql.dtype)[:, None].expand(-1, h, -1, -1)
    be = sdpa_backend(q, k, v)

    def call():
        with sdpa_kernel([be]):
            if be != SDPBackend.MATH:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      scale=1.0)
            return torch.cat([F.scaled_dot_product_attention(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], is_causal=True,
                scale=1.0) for i in range(q.shape[0])])

    name = be.name.lower() + (" (one sequence a call)"
                              if be == SDPBackend.MATH else "")
    return call, name


def mla_inputs(gen, dev, b, s, t, h, r, dr, q_dtype, kv_dtype, strided):
    """q_lat, q_rope ~ N(0, 1)·2/√(r + dr) in ``q_dtype`` (logits of a few
    units, as the model's pre-scaled queries give); c_kv, k_rope ~ N(0, 1)
    (the RMS-normed latent) in ``kv_dtype``, strided: slices of one
    (B, T, r + dr) tensor."""
    import torch

    scale = 2.0 / (r + dr) ** 0.5
    normal = lambda shape, sc: torch.randn(shape, generator=gen,
                                           device=dev).mul_(sc)
    ql = normal((b, s, h, r), scale).to(q_dtype)
    qr = normal((b, s, h, dr), scale).to(q_dtype)
    if strided:
        fused = normal((b, t, r + dr), 1.0).to(kv_dtype)
        ck, kr = fused[..., :r], fused[..., r:]
    else:
        ck, kr = (normal((b, t, w), 1.0).to(kv_dtype) for w in (r, dr))
    return ql, qr, ck, kr


def check_mla(dev):
    """``mla_attention`` against ``mla_attention_ref`` at the serving
    path's shapes.  Gates: f32 outputs within MLA_F32_TOL·max|ref|; bf16
    outputs elementwise within one bf16 ulp of the plain version's beyond
    that bound; every output finite; the SDPA yardstick within
    LIBRARY_REL_TOL of the plain version; one launch of the kernel the
    wrapper's rule names (``kernel_for``: ``mla_tc_kernel`` for a bf16
    latent, bounded at the bf16 tensor-core peak, ``mla_kernel`` for an
    f32 one, at the f32 peak)."""
    import torch

    from repro_torch.kernels import mla_attention as tm

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for label, (b, s, h, r, dr), t, qdt, kvdt, strided, main in MLA_CASES:
        x = mla_inputs(gen, dev, b, s, t, h, r, dr, getattr(torch, qdt),
                       getattr(torch, kvdt), strided)
        run = lambda: tm.mla_attention(*x)
        plain = lambda: tm.mla_attention_ref(*x)
        kernel = tm.kernel_for(x[2])
        before = dict(tm.mla_attention.kernel_launches)
        out, ref = run().float(), plain().float()
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in
                tm.mla_attention.kernel_launches.items()} == {
            k: int(k == kernel) for k in before}, (label, kernel)
        assert out.shape == (b, s, h, r) and bool(torch.isfinite(out).all())
        err = (out - ref).abs()
        max_err = float(err.max())
        f32_tol = MLA_F32_TOL * float(ref.abs().max())
        if qdt == "float32":
            ok = max_err <= f32_tol
            tol_txt = f"<= {MLA_F32_TOL:g}*max|ref| = {f32_tol:.3g}"
            over_ulp, gate_use = None, max_err / f32_tol
        else:
            ulp = bf16_ulp(ref)
            ok = bool((err <= ulp + f32_tol).all())
            tol_txt = f"<= 1 bf16 ulp + {MLA_F32_TOL:g}*max|ref| elementwise"
            over_ulp = int((err > ulp).sum())
            gate_use = float((err / (ulp + f32_tol)).max())
        del out, err
        assert ok, f"mla_attention {label} {qdt}/{kvdt}: {max_err} {tol_txt}"
        library, lib_name = mla_library(*x)
        lib_out = library()
        lib_err = float((lib_out.transpose(1, 2).float() - ref).norm()
                        / ref.norm())
        del lib_out, ref
        assert lib_err <= LIBRARY_REL_TOL, (label, lib_name, lib_err)
        main_shape = b * s * h >= 1 << 21
        library_ms = cuda_ms(library, reps=2 if main_shape else 10)
        del library
        pairs = b * mla_pairs(s, t)
        q_bytes = x[0].element_size()
        nbytes = (b * s * h * (2 * r + dr) * q_bytes
                  + b * t * (r + dr) * x[2].element_size())
        flops = 2 * (2 * r + dr) * h * pairs
        # mla_tc_kernel's products run on the bf16 tensor cores
        peak = (BF16_TC_FLOPS_PER_S if kernel == "mla_tc_kernel"
                else F32_FLOPS_PER_S)
        bnd, by = bound_ms(nbytes, flops, peak)
        ms = cuda_ms(run, reps=3 if main_shape else 10)
        case = {
            "name": "mla_attention", "case": label, "shape": [b, s, h, r, dr],
            "latent_rows": t, "dtype": f"{qdt}/{kvdt}", "strided": strided,
            "main": main, "kernel": kernel, "max_abs_err": max_err,
            "tolerance": tol_txt, "elements_beyond_one_ulp": over_ulp,
            "max_err_over_gate": gate_use, "ms": ms,
            "plain_ms": cuda_ms(plain, reps=2 if main_shape else 5),
            "library_ms": library_ms, "library": lib_name,
            "library_rel_err": lib_err, "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "flops": flops, "unmasked_pairs": pairs,
            "peak_flops": peak, "achieved_tflops": flops / ms / 1e9,
        }
        log("kernel_case " + json.dumps(case))
        if kernel == "mla_tc_kernel":
            log("kernel_model " + json.dumps({
                "name": "mla_attention", "case": label, "kernel": kernel,
                "modeled_l2_bytes": mla_modeled_l2_bytes(
                    b, s, t, h, r, dr, *tm.tc_tiles())}))
        cases.append(case)
        del x
        torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------
# phases 8-9: serving over the dense transformer stack
# ----------------------------------------------------------------------
SERVE_NODES, SERVE_SLOTS, PROMPT_LEN, NEW_TOKENS = 4, 2, 64, 16
LONG_PREFILL = 4096
# the flash prefill's last-position logits (bf16 values cast to f32)
# against the chunked prefill's: two bf16 ulps at |logit| in [4, 8),
# pinned from a run on an H100 SXM (700 W) that measured 0.039 for
# stablelm-1.6b (max |logit| 5.06) and 0.0156 for gemma2-27b (4.83);
# both prefills and the kernel are deterministic on one card
FLASH_VS_CHUNKED_TOL = 0.0625
# the flash prefill's last-position logits against the scheduler's own
# decode path (its chunked self-feeding prefill, which scales embeddings
# by the f32 root of d where the forward pass rounds it to bf16): two
# bf16 ulps at |logit| in [4, 8), pinned from runs on an H100 SXM (700 W)
# that measured 0.047 both with one init shared by the nodes (max |logit|
# 5.06) and with a distinct init per node (4.84); a step that reads
# another node's row is off by whole logits
FLASH_VS_DECODE_TOL = 0.0625
DECODE_CONTEXT = 4096   # the decode step timed again at this context


def top2_margin(logits):
    """Top-1 minus top-2 logit, per row."""
    import torch

    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def decode_path_logits(cfg, fleet, toks):
    """The scheduler's own computation of each prompt's next-token logits:
    the fleet's chunked self-feeding prefill (the decode path, einsum
    attention against the cache) over whole prompts ``(n, B, S)`` from a
    fresh cache of the scheduler's shapes, so every step repeats the
    scheduler's arithmetic on the same shapes."""
    import torch

    from repro_torch.serving.serve_step import (
        make_cache,
        make_fleet_prefill_step,
    )

    n, b, s = toks.shape
    lens = torch.full((n, b), s, dtype=torch.int32, device=toks.device)
    cache = make_cache(cfg, fleet.n_nodes, fleet.n_slots, fleet.max_seq,
                       toks.device)
    last, _, _ = make_fleet_prefill_step(cfg, fleet.layout)(
        fleet.plane, toks.to(torch.int32), lens, lens, cache)
    return last


def decode_step_times(cfg, fleet, max_seq=None, position=0, reps=5):
    """One fleet decode step (every node, every slot, one token) against a
    cache of ``max_seq`` positions (the fleet's by default), every slot at
    ``position``: its host time (synchronized wall clock), the device's
    busy time in it (the sum of its kernels' times under
    ``torch.profiler``), the device's idle share, its host-to-device
    copies (each from pageable memory waits for the stream), and the
    step's byte bound: the plane read once, plus the K/V entries up to
    ``position`` that attention must read (the one new entry written in
    place is left out; MLA's latent and rope-key entries likewise; a local
    layer's only within its window), or for the ``ssm`` family its state
    leaves read once (O(1) in the position); a hybrid config adds its
    Mamba state and conv inputs, read once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import (
        MAMBA_STATE_LEAVES,
        SSM_STATE_LEAVES,
        _layer_windows,
    )
    from repro_torch.serving.serve_step import make_cache, make_fleet_decode_step

    dev = fleet.plane.device
    max_seq = max_seq or fleet.max_seq
    step = make_fleet_decode_step(cfg, fleet.layout)
    # phase 20's dry-run check reads the step's own bytes: its inputs and
    # temporaries above what was allocated before them (the plane, and
    # whatever earlier work left)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    toks = torch.zeros((fleet.n_nodes, fleet.n_slots, 1), dtype=torch.int32,
                       device=dev)
    cache = make_cache(cfg, fleet.n_nodes, fleet.n_slots, max_seq, dev)
    cache["position"].fill_(position)
    run = lambda: step(fleet.plane, toks, cache)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    assert busy_ms > 0, "the profiler saw no device time"
    htod = sum(e.count for e in events if "HtoD" in e.key) / reps
    plane_bytes = fleet.plane.numel() * fleet.plane.element_size()
    if "k" in cache:
        kv = cache["k"]     # (n, L, B, T, KV, hd)
        entries = sum(min(position + 1, w) if w > 0 else position + 1
                      for w in _layer_windows(cfg))
        cache_bytes = 2 * (kv[:, 0].numel() // kv.shape[3]) * entries \
            * kv.element_size()
    elif "ckv" in cache:    # MLA: ckv (n, L, B, T, r), kr (n, L, B, T, dr)
        cache_bytes = sum((cache[k].numel() // cache[k].shape[3])
                          * (position + 1) * cache[k].element_size()
                          for k in ("ckv", "kr"))
    else:
        cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                          for k in SSM_STATE_LEAVES)
    cache_bytes += sum(cache[k].numel() * cache[k].element_size()
                       for k in MAMBA_STATE_LEAVES if k in cache)
    del cache
    return {"max_seq": max_seq, "position": position, "host_ms": host_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / host_ms),
            "htod_copies_per_step": htod, "plane_bytes": plane_bytes,
            "cache_bytes": cache_bytes, "baseline_bytes": base,
            "step_peak_bytes": step_peak,
            "bound_ms": (plane_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3}


def first_token_gate(label, reqs, flash, dec, tol=FLASH_VS_DECODE_TOL):
    """The kernel prefill's logits are within the fixed bound ``tol`` of
    the decode path's (the scheduler's own computation); each request's
    first token equals the decode path's argmax exactly, and the kernel
    prefill's wherever the kernel logits' top-2 margin exceeds twice that
    bound; near-ties are counted."""
    import torch

    diff = float((flash - dec).abs().max())
    assert diff <= tol, (label, diff)
    margin = top2_margin(flash)
    flat = [(r, i) for i, r in enumerate(reqs)]
    gated = ties = 0
    for r, i in flat:
        assert r.output[0] == int(torch.argmax(dec.reshape(-1, dec.shape[-1])[i])), \
            (label, r.rid)
        if float(margin.reshape(-1)[i]) > 2 * tol:
            assert r.output[0] == int(torch.argmax(
                flash.reshape(-1, flash.shape[-1])[i])), (label, r.rid)
            gated += 1
        else:
            ties += 1
    log(f"{label}: kernel prefill vs decode-path logits {diff:.4g} <= "
        f"{tol}; first tokens == decode-path argmax for "
        f"{len(flat)} of {len(flat)}; == kernel-prefill argmax for {gated} "
        f"gated (top-2 margin > 2 x {tol}), {ties} near-ties not gated")
    return {"kernel_vs_decode_max_abs": diff, "gated": gated,
            "near_ties": ties}


def run_serving(dev, flash_ms=None, cfg=None, n=SERVE_NODES,
                prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
                long_len=LONG_PREFILL, decode_context=DECODE_CONTEXT):
    """Phase 8: the serving tier at stablelm-1.6b's full width and depth.
    ``flash_ms``: the kernel's time at the long prefill's attention shape
    (phase 2's main case), for flash's share of that prefill."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.scheduler import FleetScheduler, Request
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or get_config("stablelm-1.6b")
    res = {"arch": cfg.name, "params_per_node": cfg.param_count(),
           "nodes": n}
    t0 = time.perf_counter()
    # a distinct init per node, so a step that reads another node's row
    # is caught against the per-node flash prefill
    inits = [init_params(torch.Generator(device=dev).manual_seed(i), cfg)
             for i in range(n)]
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *inits)
    del inits
    fleet = FleetScheduler(cfg, stacked, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=prompt_len + new_tokens + 1,
                           prefill_chunk=8)
    del stacked
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    res["plane_gb"] = fleet.plane.numel() * fleet.plane.element_size() / 1e9
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(n, SERVE_SLOTS,
                                                    prompt_len))
    reqs = [Request(rid=i * SERVE_SLOTS + j, prompt=prompts[i, j].tolist(),
                    max_new=new_tokens)
            for i in range(n) for j in range(SERVE_SLOTS)]
    for r in reqs:
        fleet.submit(r, node=r.rid // SERVE_SLOTS)
    t0 = time.perf_counter()
    steps = fleet.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert all(r.done and len(r.output) == new_tokens for r in reqs), \
        [len(r.output) for r in reqs]
    res.update({"requests": len(reqs), "scheduler_steps": steps,
                "serve_s": secs,
                "generated_tokens_per_s": len(reqs) * new_tokens / secs})

    res["fleet_decode_step"] = decode_step_times(cfg, fleet)
    # the same step against a cache of a real context, nearly full
    res["fleet_decode_step_long"] = decode_step_times(
        cfg, fleet, max_seq=decode_context, position=decode_context - 8)
    torch.cuda.empty_cache()
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    flash_prefill = make_forward_prefill(cfg, ForwardOptions(
        attn_impl="pallas"))
    before = fa.flash_attention.launches
    flash = flash_prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches - before
    assert launches == cfg.n_layers, launches   # one per layer, whole fleet
    chunked = make_forward_prefill(cfg, ForwardOptions(attn_impl="chunked"))(
        params, {"tokens": toks})
    assert bool(torch.isfinite(flash).all()) and flash.shape == (
        n, SERVE_SLOTS, cfg.vocab_size)
    vs_chunked = float((flash - chunked).abs().max())
    res.update({"prefill_launches": launches,
                "flash_vs_chunked_max_abs": vs_chunked,
                "max_abs_logit": float(flash.abs().max())})
    assert vs_chunked <= FLASH_VS_CHUNKED_TOL, vs_chunked
    dec = decode_path_logits(cfg, fleet, toks)
    res["first_token"] = first_token_gate("serving", reqs, flash, dec)
    del flash, chunked, dec

    # one long prefill, B = 1 per node
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             size=(n, 1, long_len)), device=dev)
    flash_prefill(params, {"tokens": long_toks[:, :, :256]})   # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fa.flash_attention.launches
    t0 = time.perf_counter()
    out = flash_prefill(params, {"tokens": long_toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert fa.flash_attention.launches - before == cfg.n_layers
    assert bool(torch.isfinite(out).all())
    res["long_prefill"] = {
        "tokens": n * long_len, "s": secs, "tokens_per_s": n * long_len / secs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if flash_ms is not None:
        # phase 2 timed the kernel at this prefill's attention shape
        res["long_prefill"]["flash_share"] = (cfg.n_layers * flash_ms
                                              / (secs * 1e3))
    del out

    # swap node 1's row for an init no node has; a new request on node 1
    # decodes with it
    other = init_params(torch.Generator(device=dev).manual_seed(n), cfg)
    ptr = fleet.plane.data_ptr()
    old_head = params["head"][1, :4, :4].clone()
    fleet.swap_node(1, other)
    assert fleet.plane.data_ptr() == ptr
    assert torch.equal(params["head"][1], other["head"])    # the old views
    assert not torch.equal(params["head"][1, :4, :4], old_head)
    del other
    new_prompts = rng.integers(0, cfg.vocab_size, size=(SERVE_SLOTS,
                                                        prompt_len))
    reqs = [Request(rid=100 + j, prompt=new_prompts[j].tolist(), max_new=4)
            for j in range(SERVE_SLOTS)]
    for r in reqs:
        fleet.submit(r, node=1)
    fleet.run_until_drained()
    node1 = tree_util.tree_map(lambda a: a[1:2], fleet.layout.unpack(fleet.plane))
    nt = torch.zeros_like(toks)
    nt[1] = torch.as_tensor(new_prompts, device=dev)
    flash = flash_prefill(node1, {"tokens": nt[1:2]})[0]
    dec = decode_path_logits(cfg, fleet, nt)[1]
    res["swap_first_token"] = first_token_gate("swap_node", reqs, flash, dec)
    del fleet, params, node1
    torch.cuda.empty_cache()
    log("serving " + json.dumps(res))
    return res


def run_gemma2(dev, cfg=None, seq=8192):
    """Phase 9: gemma2-27b at full width, its first local and global
    layer, one prefill of S tokens through the flash kernel (2 launches)
    against the chunked one."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import (
        ForwardOptions,
        add_node_axis,
        init_params,
    )
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or dataclasses.replace(get_config("gemma2-27b"), n_layers=2)
    assert cfg.layer_kinds() == ("local", "global")
    params = add_node_axis(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 1, seq)), device=dev)
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "seq": seq}
    out = {}
    for impl in ("pallas", "chunked"):
        prefill = make_forward_prefill(cfg, ForwardOptions(attn_impl=impl))
        before = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[impl] = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        res[f"{impl}_s"] = time.perf_counter() - t0
        res[f"{impl}_launches"] = fa.flash_attention.launches - before
    assert res["pallas_launches"] == 2 and res["chunked_launches"] == 0, res
    assert bool(torch.isfinite(out["pallas"]).all())
    diff = float((out["pallas"] - out["chunked"]).abs().max())
    res.update({"flash_vs_chunked_max_abs": diff,
                "max_abs_logit": float(out["pallas"].abs().max()),
                "argmax_equal": bool(torch.equal(
                    out["pallas"].argmax(-1), out["chunked"].argmax(-1)))})
    log("gemma2 " + json.dumps(res))
    assert diff <= FLASH_VS_CHUNKED_TOL, diff
    del params, out
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# phase 10: serving the RWKV-6 family
# ----------------------------------------------------------------------
# n = 2, not phase 8's 4: the two f32 leaf kinds (decay_base, bonus_u)
# make the plane f32, 12.4 GB per node, and each fleet step casts its
# 3.1 B bf16 leaves back out (a fresh 6.2 GB per node)
RWKV_NODES = 2
RWKV_PARAMS = 3_099_694_080     # rwkv6-3b per node (the reference's tree)
# each layer's time-mix output and final state through the scan kernel
# against the plain scan body on the same input (the plain path's hidden
# state), relative Frobenius error: pinned from a run on an H100 SXM
# (700 W) that measured 5.9e-5 to 1.62e-4 over the 32 layers (bf16).  No
# end-to-end logit bound can hold: at this random init the model is
# chaotic, and a difference in the last bit grows a few times a layer,
# in f32 too (``rwkv_layer_errors`` prints it); that run's kernel and
# plain prefills parted by 6.2 logits
RWKV_LAYER_REL_TOL = 1e-3


def serve_wave(fleet, prompts, rid0, new_tokens):
    """Submit ``prompts`` (n, slots, S) to their nodes, drain, and return
    the requests, the scheduler steps and the seconds."""
    import torch

    from repro_torch.serving.scheduler import Request

    n, slots, _ = prompts.shape
    reqs = [Request(rid=rid0 + i * slots + j, prompt=prompts[i, j].tolist(),
                    max_new=new_tokens)
            for i in range(n) for j in range(slots)]
    for r in reqs:
        fleet.submit(r, node=(r.rid - rid0) // slots)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = fleet.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert all(r.done and len(r.output) == new_tokens for r in reqs), \
        [len(r.output) for r in reqs]
    return reqs, steps, secs


def unpack_device_ms(layout, plane, reps=3):
    """Device time of one ``PlaneLayout.unpack`` of the plane (the casts
    of its bf16 leaves out of the f32 plane), from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    layout.unpack(plane)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            layout.unpack(plane)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / reps


def rwkv_layer_errors(cfg, params, toks):
    """Each layer's time-mix (output and final state) through the scan
    kernel against the plain scan body on the same input, the plain
    path's hidden state: the relative Frobenius error of each layer (the
    larger of the two).  Beside it, the kernel path's own hidden state,
    carried through the layers, against the plain path's: how a
    difference grows with depth.  Its kernel launches compare the kernel
    with its plain version, so they are taken back out of the count."""
    import torch

    from repro_torch.kernels import ssm_scan as ts
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import norm_apply

    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    kernel = tt.ForwardOptions(use_ssm_kernel=True)
    launches = ts.rwkv_scan.launches
    shapes = dict(getattr(ts.rwkv_scan, "shapes", {}))
    x = xk = tt._embed_inputs(params, cfg, toks)
    local, carried = [], []
    for i in range(cfg.n_layers):
        lp = tt._layer(params["dense_layers"], i)
        h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
        out_k, st_k, _ = ssm_lib.rwkv_time_mix(lp["time_mix"], cfg, h,
                                               use_kernel=True)
        out_p, st_p, _ = ssm_lib.rwkv_time_mix(lp["time_mix"], cfg, h)
        local.append(max(rel(out_k, out_p), rel(st_k, st_p)))
        x, _ = tt._rwkv_layer(lp, cfg, x, tt.ForwardOptions())
        xk, _ = tt._rwkv_layer(lp, cfg, xk, kernel)
        carried.append(rel(xk, x))
    assert ts.rwkv_scan.launches - launches == 2 * cfg.n_layers
    ts.rwkv_scan.launches = launches
    if hasattr(ts.rwkv_scan, "shapes"):
        ts.rwkv_scan.shapes.clear()
        ts.rwkv_scan.shapes.update(shapes)
    return local, carried


def depth_samples(values):
    """``{layer: value}`` after layers 1, 2, 4, 8, ... and the last."""
    n = len(values)
    layers = sorted({min(2 ** i, n) for i in range(n.bit_length() + 1)})
    return {k: float(f"{values[k - 1]:.3g}") for k in layers}


def decode_path_gate(label, reqs, kern, dec):
    """Each request's first token equals the argmax of the decode path's
    logits (the scheduler's own arithmetic, so exactly); how many also
    equal the kernel prefill's argmax is counted, not gated: the random
    init is chaotic, and two summation orders part by O(1) logits."""
    import torch

    flat_dec = dec.reshape(-1, dec.shape[-1])
    flat_kern = kern.reshape(-1, kern.shape[-1])
    same = 0
    for i, r in enumerate(reqs):
        assert r.output[0] == int(torch.argmax(flat_dec[i])), (label, r.rid)
        same += r.output[0] == int(torch.argmax(flat_kern[i]))
    diff = float((kern - dec).abs().max())
    log(f"{label}: first tokens == decode-path argmax for {len(reqs)} of "
        f"{len(reqs)}; == kernel-prefill argmax for {same} (not gated); "
        f"kernel prefill vs decode-path logits {diff:.4g} (not gated)")
    return {"kernel_vs_decode_logits_max_abs": diff,
            "equal_to_kernel_argmax": same, "requests": len(reqs)}


# rwkv6-3b at full width cut to 2 layers: the kernel prefill's
# last-position logits against the plain scan body's and the decode
# path's, by dtype (kernel vs plain, kernel vs decode path).  bf16 is the
# serving dtype, but there the decode path's input already differs from
# the prefill's in the last bit (it scales the embedding by the f32 root
# of d, the forward pass by that root rounded to bf16), and a random init
# grows such a difference many times a layer; in f32 both paths compute
# the same values in other summation orders.  Pinned from a run on an
# H100 SXM (700 W) that measured, bf16: 0.031 (one ulp at max |logit|
# 4.28) and 1.14; f32: 2.6e-5 and 7.2e-5 (max |logit| 4.59)
RWKV_CUT_LAYERS = 2
RWKV_CUT_TOLS = {"bfloat16": (0.0625, 1.5), "float32": (1e-4, 2.5e-4)}


def run_rwkv_cut(dev, cfg, n, prompts, new_tokens, dtype):
    """rwkv6-3b at full width cut to ``RWKV_CUT_LAYERS`` layers, where a
    random init is not yet chaotic, in ``dtype``: a fleet of n distinct
    inits drawn on the card serves the phase's prompts (their first
    tokens), and the kernel prefill (one launch a layer) is held against
    the plain scan body's and the decode path's logits by the fixed
    bounds ``RWKV_CUT_TOLS[dtype]``, and its argmax against each first
    token wherever the top-2 margin exceeds twice the decode bound."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.kernels import ssm_scan as ts
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.scheduler import FleetScheduler
    from repro_torch.serving.serve_step import make_forward_prefill

    cut = dataclasses.replace(cfg, n_layers=RWKV_CUT_LAYERS, dtype=dtype,
                              param_dtype=dtype)
    plain_tol, decode_tol = RWKV_CUT_TOLS[dtype]
    label = f"rwkv6-3b cut to {cut.n_layers} layers, {dtype}"
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[init_params(torch.Generator(device=dev).manual_seed(i), cut)
          for i in range(n)])
    fleet = FleetScheduler(cut, stacked, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=prompts.shape[-1] + new_tokens + 1,
                           prefill_chunk=8)
    del stacked
    reqs, _, _ = serve_wave(fleet, prompts, 300, new_tokens)
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    before = ts.rwkv_scan.launches
    kern = make_forward_prefill(cut, ForwardOptions(use_ssm_kernel=True))(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = ts.rwkv_scan.launches - before
    assert launches == cut.n_layers, launches
    plain = make_forward_prefill(cut, ForwardOptions())(params,
                                                        {"tokens": toks})
    assert bool(torch.isfinite(kern).all())
    vs_plain = float((kern - plain).abs().max())
    res = {"layers": cut.n_layers, "nodes": n, "dtype": dtype,
           "prefill_launches": launches, "kernel_vs_plain_max_abs": vs_plain,
           "max_abs_logit": float(kern.abs().max())}
    log(f"{label}: kernel prefill vs plain scan body logits {vs_plain:.4g} "
        f"<= {plain_tol} (max |logit| {res['max_abs_logit']:.4g})")
    assert vs_plain <= plain_tol, (label, vs_plain)
    dec = decode_path_logits(cut, fleet, toks)
    res["first_token"] = first_token_gate(label, reqs, kern, dec, decode_tol)
    del fleet, params, kern, plain, dec
    torch.cuda.empty_cache()
    return res


def run_rwkv(dev, scan_ms=None, cfg=None, n=RWKV_NODES,
             prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
             long_len=LONG_PREFILL, decode_context=DECODE_CONTEXT,
             n_params=RWKV_PARAMS):
    """Phase 10: the serving tier over rwkv6-3b at full width and depth.
    ``scan_ms``: the kernel's time at the long prefill's scan shape
    (phase 2's main case), for the kernel's share of that prefill."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssm_scan as ts
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.scheduler import FleetScheduler, Request
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or get_config("rwkv6-3b")
    t0 = time.perf_counter()
    # a distinct init per node, so a step that reads another node's row
    # is caught against the per-node prefill
    inits = [init_params(torch.Generator(device=dev).manual_seed(i), cfg)
             for i in range(n)]
    per_node = sum(x.numel() for x in tree_util.leaves(inits[0]))
    assert per_node == n_params, per_node
    res = {"arch": cfg.name, "params_per_node": per_node, "nodes": n,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "f32_params_per_node": sum(
               x.numel() for x in tree_util.leaves(inits[0])
               if x.dtype == torch.float32)}
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *inits)
    del inits
    max_seq = prompt_len + new_tokens + 1
    fleet = FleetScheduler(cfg, stacked, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, prefill_chunk=8)
    del stacked
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    res["plane_dtype"] = str(fleet.plane.dtype).replace("torch.", "")
    res["plane_bytes"] = fleet.plane.numel() * fleet.plane.element_size()
    log(f"rwkv6-3b fleet of {n}: {res['plane_dtype']} plane of "
        f"{res['plane_bytes']} bytes")
    rng = np.random.default_rng(1)
    shape = (n, SERVE_SLOTS, prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, size=shape)
    reqs, steps, secs = serve_wave(fleet, prompts, 0, new_tokens)
    res.update({"requests": len(reqs), "scheduler_steps": steps,
                "serve_s": secs,
                "generated_tokens_per_s": len(reqs) * new_tokens / secs})

    # a second wave into the freed slots, against a fresh scheduler
    prompts2 = rng.integers(0, cfg.vocab_size, size=shape)
    reused, _, res["reused_serve_s"] = serve_wave(fleet, prompts2, 100,
                                                  new_tokens)
    # the unpacked f32 leaves are views of the plane: copy them, so that
    # the old plane is freed before the fresh scheduler packs its own
    params = tree_util.tree_map(
        lambda t: t.clone() if t.dtype == torch.float32 else t,
        fleet.layout.unpack(fleet.plane))
    del fleet
    torch.cuda.empty_cache()
    fresh = FleetScheduler(cfg, params, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, prefill_chunk=8)
    del params
    torch.cuda.empty_cache()
    first, _, _ = serve_wave(fresh, prompts2, 100, new_tokens)
    assert [r.output for r in reused] == [r.output for r in first], \
        "a re-used slot served other tokens than a fresh scheduler"
    res["readmission_equal"] = len(reused)
    log(f"rwkv6-3b re-admission: the {len(reused)} requests of the second "
        f"wave == the same prompts on a fresh FleetScheduler, token for "
        f"token")
    fleet = fresh
    del first, reused

    # the full-sequence prefill through the scan kernel
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    scan_prefill = make_forward_prefill(cfg, ForwardOptions(
        use_ssm_kernel=True))
    before = ts.rwkv_scan.launches
    kern = scan_prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = ts.rwkv_scan.launches - before
    assert launches == cfg.n_layers, launches   # one per layer, whole fleet
    plain = make_forward_prefill(cfg, ForwardOptions())(params,
                                                        {"tokens": toks})
    assert ts.rwkv_scan.launches - before == launches
    assert bool(torch.isfinite(kern).all()) and kern.shape == (
        n, SERVE_SLOTS, cfg.vocab_size)
    local, carried = rwkv_layer_errors(cfg, params, toks)
    # the same on node 0's weights cast to f32: a carried difference that
    # grows as fast there is no bf16 rounding effect
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    local32, carried32 = rwkv_layer_errors(
        f32, tree_util.tree_map(lambda a: a[:1].float(), params), toks[:1])
    worst = max(local)
    res.update({"prefill_launches": launches,
                "layer_rel_err_max": worst, "layer_rel_err": local,
                "carried_rel_diff": carried,
                "f32_layer_rel_err_max": max(local32),
                "f32_carried_rel_diff": carried32,
                "kernel_vs_plain_logits_max_abs": float(
                    (kern - plain).abs().max()),
                "max_abs_logit": float(kern.abs().max())})
    log(f"rwkv6-3b prefill: {launches} rwkv_scan launches; per layer, "
        f"kernel vs plain scan body on the same input: relative error "
        f"<= {worst:.3g} (gate {RWKV_LAYER_REL_TOL}; f32 "
        f"{max(local32):.3g}); the difference carried through the layers "
        f"(not gated), by layer: {depth_samples(carried)} (f32 "
        f"{depth_samples(carried32)}); logits "
        f"{res['kernel_vs_plain_logits_max_abs']:.4g} apart, max |logit| "
        f"{res['max_abs_logit']:.4g}")
    assert worst <= RWKV_LAYER_REL_TOL, local
    del params
    dec = decode_path_logits(cfg, fleet, toks)
    res["first_token"] = decode_path_gate("rwkv6-3b serving", reqs, kern,
                                          dec)
    del kern, plain, dec
    res["cut"] = {dt: run_rwkv_cut(dev, cfg, n, prompts, new_tokens, dt)
                  for dt in RWKV_CUT_TOLS}

    # one long prefill, B = 1 per node
    params = fleet.layout.unpack(fleet.plane)
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             size=(n, 1, long_len)), device=dev)
    scan_prefill(params, {"tokens": long_toks[:, :, :256]})   # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ts.rwkv_scan.launches
    t0 = time.perf_counter()
    out = scan_prefill(params, {"tokens": long_toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert ts.rwkv_scan.launches - before == cfg.n_layers
    assert bool(torch.isfinite(out).all())
    res["long_prefill"] = {
        "tokens": n * long_len, "s": secs, "tokens_per_s": n * long_len / secs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if scan_ms is not None:
        # phase 2 timed the kernel at this prefill's scan shape
        res["long_prefill"]["scan_share"] = cfg.n_layers * scan_ms / (secs
                                                                      * 1e3)
    del out, params
    torch.cuda.empty_cache()

    # the fleet decode step: O(1) state, so the position should not matter
    res["fleet_decode_step"] = decode_step_times(cfg, fleet, position=81)
    res["fleet_decode_step_long"] = decode_step_times(
        cfg, fleet, max_seq=decode_context, position=decode_context - 8)
    unpack_ms = unpack_device_ms(fleet.layout, fleet.plane)
    res["unpack_device_ms"] = unpack_ms
    res["unpack_share_of_step"] = (
        unpack_ms / res["fleet_decode_step"]["device_busy_ms"])
    log(f"rwkv6-3b decode step: device {res['fleet_decode_step']['device_busy_ms']:.4g}"
        f" ms at position 81, {res['fleet_decode_step_long']['device_busy_ms']:.4g}"
        f" ms at {decode_context - 8}; the plane's unpack casts "
        f"{unpack_ms:.4g} ms ({100 * res['unpack_share_of_step']:.1f}%)")
    torch.cuda.empty_cache()

    # swap node 1's row for an init no node has; a new request on node 1
    # decodes with it
    other = init_params(torch.Generator(device=dev).manual_seed(n), cfg)
    ptr = fleet.plane.data_ptr()
    f32_view = fleet.layout.unpack(fleet.plane)["dense_layers"]["time_mix"][
        "bonus_u"]
    fleet.swap_node(1, other)
    assert fleet.plane.data_ptr() == ptr
    assert torch.equal(f32_view[1], other["dense_layers"]["time_mix"][
        "bonus_u"])                                       # an old view
    head = next(sl for (path, _), sl in zip(
        tree_util.leaves_with_paths(other), fleet.layout.slots)
        if path == ("head",))
    assert torch.equal(fleet.plane[1, head.offset:head.offset + head.size],
                       other["head"].reshape(-1).float())
    del other, f32_view
    new_prompts = rng.integers(0, cfg.vocab_size, size=(SERVE_SLOTS,
                                                        prompt_len))
    reqs = [Request(rid=200 + j, prompt=new_prompts[j].tolist(), max_new=4)
            for j in range(SERVE_SLOTS)]
    for r in reqs:
        fleet.submit(r, node=1)
    fleet.run_until_drained()
    node1 = tree_util.tree_map(lambda a: a[1:2],
                               fleet.layout.unpack(fleet.plane))
    nt = torch.zeros_like(toks)
    nt[1] = torch.as_tensor(new_prompts, device=dev)
    kern = scan_prefill(node1, {"tokens": nt[1:2]})[0]
    del node1
    dec = decode_path_logits(cfg, fleet, nt)[1]
    res["swap_first_token"] = decode_path_gate("rwkv6-3b swap_node", reqs,
                                               kern, dec)
    del fleet, kern, dec
    torch.cuda.empty_cache()
    log("serving_rwkv " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# phase 11: serving MLA, deepseek-v2 cut to its dense first layer
# ----------------------------------------------------------------------
DEEPSEEK_NODES = 4
DEEPSEEK_PARAMS = 1_386_562_560   # per node: the reference's 17-leaf tree
DEEPSEEK_REDUCED = {
    "n_layers": "60 -> 1: the dense first layer (first_k_dense = 1); "
                "layers 2-60 are MoE layers, whose block is not ported"}
# the kernel prefill's last-position logits (bf16 values cast to f32)
# against the plain chunked prefill's and against the scheduler's decode
# path: two bf16 ulps at |logit| in [4, 8), pinned from a run on an H100
# SXM (700 W) that measured 0.031 and 0.033 (max |logit| 4.63); a step
# that reads another node's row is off by whole logits
MLA_VS_PLAIN_TOL = 0.0625
MLA_VS_DECODE_TOL = 0.0625


def run_deepseek(dev, mla_ms=None, cfg=None, n=DEEPSEEK_NODES,
                 prompt_len=PROMPT_LEN, new_tokens=NEW_TOKENS,
                 long_len=LONG_PREFILL, decode_context=DECODE_CONTEXT,
                 n_params=DEEPSEEK_PARAMS):
    """Phase 11: the serving tier over deepseek-v2-236b at full width, cut
    to its dense first layer (MLA attention, SwiGLU FFN).  ``mla_ms``: the
    kernel's time at the long prefill's attention shape (phase 2's main
    case), for the kernel's share of that prefill."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mla_attention as tm
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.scheduler import FleetScheduler, Request
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or dataclasses.replace(get_config("deepseek-v2-236b"),
                                     n_layers=1)
    assert cfg.use_mla and cfg.n_layers <= cfg.first_k_dense
    log(f"{cfg.name}: reduced {json.dumps(DEEPSEEK_REDUCED)}")
    t0 = time.perf_counter()
    # a distinct init per node, so a step that reads another node's row
    # is caught against the per-node prefill
    inits = [init_params(torch.Generator(device=dev).manual_seed(i), cfg)
             for i in range(n)]
    leaves = tree_util.leaves(inits[0])
    per_node = sum(x.numel() for x in leaves)
    assert per_node == n_params, per_node
    res = {"arch": cfg.name, "reduced": DEEPSEEK_REDUCED,
           "params_per_node": per_node, "leaves": len(leaves), "nodes": n,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
           "dtypes": sorted({str(x.dtype) for x in leaves})}
    stacked = tree_util.tree_map(lambda *xs: torch.stack(xs), *inits)
    del inits, leaves
    max_seq = prompt_len + new_tokens + 1
    fleet = FleetScheduler(cfg, stacked, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, prefill_chunk=8)
    del stacked
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    res["plane_dtype"] = str(fleet.plane.dtype).replace("torch.", "")
    res["plane_bytes"] = fleet.plane.numel() * fleet.plane.element_size()
    log(f"{cfg.name} fleet of {n}: {res['plane_dtype']} plane of "
        f"{res['plane_bytes']} bytes, {per_node} parameters a node")
    rng = np.random.default_rng(3)
    shape = (n, SERVE_SLOTS, prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, size=shape)
    reqs, steps, secs = serve_wave(fleet, prompts, 0, new_tokens)
    res.update({"requests": len(reqs), "scheduler_steps": steps,
                "serve_s": secs,
                "generated_tokens_per_s": len(reqs) * new_tokens / secs})

    # a second wave into the freed slots, against a fresh scheduler: the
    # latent cache keeps the first wave's entries past position
    prompts2 = rng.integers(0, cfg.vocab_size, size=shape)
    reused, _, res["reused_serve_s"] = serve_wave(fleet, prompts2, 100,
                                                  new_tokens)
    params = fleet.layout.unpack(fleet.plane)   # views of the bf16 plane
    del fleet
    fresh = FleetScheduler(cfg, params, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, prefill_chunk=8)
    del params
    torch.cuda.empty_cache()
    first, _, _ = serve_wave(fresh, prompts2, 100, new_tokens)
    assert [r.output for r in reused] == [r.output for r in first], \
        "a re-used slot served other tokens than a fresh scheduler"
    res["readmission_equal"] = len(reused)
    log(f"{cfg.name} re-admission: the {len(reused)} requests of the second "
        f"wave == the same prompts on a fresh FleetScheduler, token for "
        f"token")
    fleet = fresh
    del first, reused

    # the full-sequence prefill through the latent-attention kernel
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    kern_prefill = make_forward_prefill(cfg, ForwardOptions(
        attn_impl="pallas"))
    before = tm.mla_attention.launches
    tc_before = tm.mla_attention.kernel_launches["mla_tc_kernel"]
    kern = kern_prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = tm.mla_attention.launches - before
    assert launches == cfg.n_layers, launches   # one per layer, whole fleet
    # a bf16 model's latent is bf16: the tensor-core kernel
    tc = tm.mla_attention.kernel_launches["mla_tc_kernel"] - tc_before
    assert tc == (launches if cfg.activation_dtype == torch.bfloat16
                  else 0), tc
    plain = make_forward_prefill(cfg, ForwardOptions(attn_impl="chunked"))(
        params, {"tokens": toks})
    assert tm.mla_attention.launches - before == launches
    assert bool(torch.isfinite(kern).all()) and kern.shape == (
        n, SERVE_SLOTS, cfg.vocab_size)
    vs_plain = float((kern - plain).abs().max())
    res.update({"prefill_launches": launches,
                "prefill_tc_kernel_launches": tc,
                "kernel_vs_plain_max_abs": vs_plain,
                "max_abs_logit": float(kern.abs().max())})
    log(f"{cfg.name} prefill: {launches} mla_attention launch(es); kernel "
        f"vs plain chunked prefill logits {vs_plain:.4g} <= "
        f"{MLA_VS_PLAIN_TOL} (max |logit| {res['max_abs_logit']:.4g})")
    assert vs_plain <= MLA_VS_PLAIN_TOL, vs_plain
    dec = decode_path_logits(cfg, fleet, toks)
    res["first_token"] = first_token_gate(f"{cfg.name} serving", reqs, kern,
                                          dec, MLA_VS_DECODE_TOL)
    del kern, plain, dec

    # one long prefill, B = 1 per node
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             size=(n, 1, long_len)), device=dev)
    kern_prefill(params, {"tokens": long_toks[:, :, :256]})   # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = tm.mla_attention.launches
    t0 = time.perf_counter()
    out = kern_prefill(params, {"tokens": long_toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert tm.mla_attention.launches - before == cfg.n_layers
    assert bool(torch.isfinite(out).all())
    res["long_prefill"] = {
        "tokens": n * long_len, "s": secs, "tokens_per_s": n * long_len / secs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if mla_ms is not None:
        # phase 2 timed the kernel at this prefill's attention shape
        res["long_prefill"]["kernel_share"] = (cfg.n_layers * mla_ms
                                               / (secs * 1e3))
    del out, params
    torch.cuda.empty_cache()

    # one fleet decode step against a short and a long latent cache
    res["fleet_decode_step"] = decode_step_times(cfg, fleet, max_seq=128,
                                                 position=81)
    res["fleet_decode_step_long"] = decode_step_times(
        cfg, fleet, max_seq=decode_context, position=decode_context - 8)
    torch.cuda.empty_cache()

    # swap node 1's row for an init no node has; a new request on node 1
    # decodes with it
    other = init_params(torch.Generator(device=dev).manual_seed(n), cfg)
    ptr = fleet.plane.data_ptr()
    views = fleet.layout.unpack(fleet.plane)
    old_head = views["head"][1, :4, :4].clone()
    fleet.swap_node(1, other)
    assert fleet.plane.data_ptr() == ptr
    assert torch.equal(views["head"][1], other["head"])    # the old views
    assert not torch.equal(views["head"][1, :4, :4], old_head)
    del other, views
    new_prompts = rng.integers(0, cfg.vocab_size, size=(SERVE_SLOTS,
                                                        prompt_len))
    reqs = [Request(rid=200 + j, prompt=new_prompts[j].tolist(), max_new=4)
            for j in range(SERVE_SLOTS)]
    for r in reqs:
        fleet.submit(r, node=1)
    fleet.run_until_drained()
    node1 = tree_util.tree_map(lambda a: a[1:2],
                               fleet.layout.unpack(fleet.plane))
    nt = torch.zeros_like(toks)
    nt[1] = torch.as_tensor(new_prompts, device=dev)
    kern = kern_prefill(node1, {"tokens": nt[1:2]})[0]
    del node1
    dec = decode_path_logits(cfg, fleet, nt)[1]
    res["swap_first_token"] = first_token_gate(f"{cfg.name} swap_node", reqs,
                                               kern, dec, MLA_VS_DECODE_TOL)
    del fleet, kern, dec
    torch.cuda.empty_cache()
    log("serving_deepseek " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# phase 16: serving the MoE block, deepseek-v2 and llama4-scout
# ----------------------------------------------------------------------
MOE_NODES = 2
MOE_BUDGET_S = 180
# per node, the reference's trees (jax.eval_shape of its init_params at
# these depths; tests/test_torch_moe.py holds the port's tree to them)
MOE_CUTS = {
    "deepseek-v2-236b": {
        "layers": 2, "params": 5_358_679_040, "leaves": 35,
        "reduced": {"n_layers": "60 -> 2: the dense first layer "
                                "(first_k_dense = 1) and one MoE layer"}},
    "llama4-scout-17b-a16e": {
        "layers": 1, "params": 4_271_078_656, "leaves": 18,
        "reduced": {"n_layers": "48 -> 1: one MoE layer, the all-MoE "
                                "branch (no dense_layers)"}},
}
# at the published capacity factor 1.25 the kernel prefill and the plain
# chunked prefill route bf16 activations through an f32 router, and a
# near-tie in the top-k can flip: the share of (token, slot) assignments
# (and keep decisions, which a flip moves for the later tokens of both
# experts) that differ, and the last-position logits of the sequences
# whose own assignments agree in every MoE layer, two bf16 ulps at
# |logit| in [4, 8).  Pinned from a run on an H100 SXM (700 W) that
# measured, deepseek-v2 (2 × 64 tokens a node, cap 6, 60% of the pairs
# dropped): 3.78% flipped, the 4 of 4 agreeing sequences' logits 0.044
# apart (max |logit| 5.19)
MOE_FLIP_SHARE_MAX = 0.08
MOE_VS_PLAIN_TOL = 0.0625
# the kernel prefill against the decode path at a dropless capacity
# factor (E / k, so cap = t and no pair drops in either): four bf16 ulps
# at |logit| in [4, 8), pinned from the same run, which measured 0.0625
# and 0.0645 for deepseek-v2's two gates (before and after the swap)
MOE_VS_DECODE_TOL = 0.125
# what that bound sees (planted faults, PlantedFault, on an H100 SXM
# (700 W)): a routing fault moves the logits by 6.4 (deepseek-v2) and 6.8
# (llama4-scout), un-renormalised gates by 3.5 and 0.055.  llama4-scout's
# one routed expert outweighs its shared one at this init, so a per-token
# scale of the routed term vanishes in the final norm and no logit bound
# can see it; the block gate below holds the gates
# the MoE block (``moe_apply``) against ``plain_moe`` on the MoE layer's
# input in the dropless kernel prefill, relative Frobenius error: the
# same card measured 1.04e-3 (deepseek-v2) and 0 (llama4-scout), and
# with the planted faults route 1.40 and 1.42, gate 0.80 and 0.76
MOE_BLOCK_REL_TOL = 1e-2
# waves timed for the served rate, after the first wave (which warms the
# fleet up and runs inside the route recorder): 4 requests of 16 tokens
# each, so 256 generated tokens over 92 scheduler steps
MOE_RATE_WAVES = 4


def plain_moe(p, cfg, tokens):
    """The MoE block's function with every pair kept (a dropless
    capacity), written apart from ``models.moe``: the f32 router's top k,
    renormalised; per node and expert, the tokens whose top k hold it
    through that expert's MLP, weighted by their gate and summed in f32;
    then the shared experts.  ``tokens`` ``(N, T, D)`` → ``(N, T, D)``."""
    import torch

    from repro_torch.models.layers import _gelu, mlp_apply

    n, t, d = tokens.shape
    probs = torch.softmax(torch.bmm(tokens.float(), p["router"]), -1)
    top, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    ex = p["experts"]
    out = torch.zeros((n, t, d), dtype=torch.float32, device=tokens.device)
    for i in range(n):
        for e in range(cfg.n_experts):
            tok, slot = (ids[i] == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            x = tokens[i, tok]
            if "wg" in ex:
                act = (torch.nn.functional.silu if cfg.mlp_kind == "swiglu"
                       else _gelu)
                h = act(x @ ex["wg"][i, e]) * (x @ ex["wi"][i, e])
            else:
                h = _gelu(x @ ex["wi"][i, e])
            out[i].index_add_(0, tok, (h @ ex["wo"][i, e]).float()
                              * gates[i, tok, slot, None])
    out = out.to(tokens.dtype)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], tokens[:, None], cfg.mlp_kind)[:, 0]
    return out


def moe_block_check(cfg, p, tokens):
    """``moe_apply`` against ``plain_moe`` on one MoE layer's input
    ``(N, T, D)`` at a dropless ``cfg``, and with each planted fault:
    relative Frobenius errors."""
    from repro_torch.models import moe

    ref = plain_moe(p, cfg, tokens).float()
    rel = lambda: float((moe.moe_apply(p, cfg, tokens[:, None])[0][:, 0]
                         .float() - ref).norm() / ref.norm())
    res = {"rel_err": rel()}
    for kind in ("route", "gate"):
        with PlantedFault(kind):
            res[f"planted_{kind}_rel_err"] = rel()
    return res


class PlantedFault:
    """A deliberately wrong MoE block, patched into ``models.moe.route``
    inside the ``with`` (as ``RouteLog`` records it), for the negative
    controls of the dropless gate: ``"route"`` routes every token by the
    router's columns rolled by one expert (each token's top-k taken from
    its neighbours' logits), ``"gate"`` leaves the gates un-renormalised
    over k (each kept pair weighted by its softmax probability)."""

    def __init__(self, kind):
        assert kind in ("route", "gate"), kind
        self.kind = kind

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.moe, self.orig = moe, moe.route

        def route(p, cfg, tokens):
            if self.kind == "route":
                return self.orig({**p, "router": p["router"].roll(1, -1)},
                                 cfg, tokens)
            r = self.orig(p, cfg, tokens)
            probs = torch.softmax(torch.bmm(tokens.float(), p["router"]), -1)
            return r._replace(gates=r.gates * probs.gather(
                -1, r.expert_ids).sum(-1, keepdim=True))

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


class RouteLog:
    """Records every ``models.moe.route`` call made inside the ``with``:
    the experts and keep masks (copies), and with ``keep_last`` the last
    call's params and tokens (for timing the block's parts at the path's
    shapes).  Holding them across the steps of a served wave would keep
    one step's cast expert weights alive into the next step's unpack
    (15.1 GB for deepseek-v2), so only single calls keep them."""

    def __init__(self, keep_last=False):
        self.keep_last = keep_last

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.calls, self.last = moe, moe.route, [], None

        def route(p, cfg, tokens):
            r = self.orig(p, cfg, tokens)
            self.calls.append((r.expert_ids.clone(), r.keep.clone()))
            if self.keep_last:
                self.last = (p, tokens)
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def dropped_share(self) -> float:
        pairs = sum(k.numel() for _, k in self.calls)
        return sum(int((~k).sum()) for _, k in self.calls) / max(pairs, 1)


def route_agreement(a, b):
    """Two prefills' routings (one ``RouteLog`` call per MoE layer, each
    ``(n, T, k)``): the share of (token, slot) assignments whose expert or
    keep decision differ, and an ``(n, T)`` mask of the tokens whose
    top-k sets and keep decisions agree in every layer."""
    import torch

    assert len(a.calls) == len(b.calls)
    differ, total, agree = 0, 0, None
    for (ea, ka), (eb, kb) in zip(a.calls, b.calls):
        differ += int(((ea != eb) | (ka != kb)).sum())
        total += ea.numel()
        sa, ia = torch.sort(ea, dim=-1)
        sb, ib = torch.sort(eb, dim=-1)
        same = ((sa == sb).all(-1)
                & (ka.gather(-1, ia) == kb.gather(-1, ib)).all(-1))
        agree = same if agree is None else agree & same
    return differ / total, agree


def moe_part_ms(cfg, p, tokens):
    """Device ms of the MoE block's parts on one layer's input ``tokens``
    ``(n, T, D)`` (CUDA-event medians): the router (logits, top-k,
    positions), the dispatch into ``(n, E, C, D)``, the expert products,
    the gate-weighted combine and the shared experts; and the expert
    products' achieved TFLOP/s (2·n·E·C·3·d·fe operations)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_apply

    e, kind = cfg.n_experts, cfg.mlp_kind
    r = moe.route(p, cfg, tokens)
    buf = moe.dispatch(r, tokens, e)
    out_buf = moe.expert_ffn(p["experts"], buf, kind)
    ms = {"router": cuda_ms(lambda: moe.route(p, cfg, tokens), reps=5),
          "dispatch": cuda_ms(lambda: moe.dispatch(r, tokens, e), reps=5),
          "experts": cuda_ms(lambda: moe.expert_ffn(p["experts"], buf, kind),
                             reps=5),
          "combine": cuda_ms(lambda: moe.combine(r, out_buf, tokens.dtype),
                             reps=5)}
    if "shared" in p:
        ms["shared"] = cuda_ms(lambda: mlp_apply(p["shared"], tokens, kind),
                               reps=5)
    n, t, d = tokens.shape
    flops = 2 * n * e * r.cap * len(p["experts"]) * d * cfg.moe_d_ff_
    return {"tokens_per_node": t, "cap": r.cap, "ms": ms,
            "block_ms": sum(ms.values()), "expert_flops": flops,
            "expert_tflops": flops / (ms["experts"] * 1e-3) / 1e12,
            "expert_share_of_bf16_peak": flops / (ms["experts"] * 1e-3)
            / BF16_TC_FLOPS_PER_S}


def moe_fleet(cfg, n, dev, max_seq, cut):
    """The fleet in one plane, built without a stacked copy: node 0's
    init, broadcast to n rows, packs the plane; each other node's own
    init is then drawn and written into its row (``swap_node``) and
    dropped, so the peak is the plane and two inits.  Returns the
    scheduler and what was checked and measured."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.scheduler import FleetScheduler

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    leaves = tree_util.leaves(first)
    per_node = sum(x.numel() for x in leaves)
    assert per_node == cut["params"] and len(leaves) == cut["leaves"], (
        per_node, len(leaves))
    res = {"arch": cfg.name, "reduced": cut["reduced"],
           "params_per_node": per_node, "leaves": len(leaves), "nodes": n,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
           "capacity_factor": cfg.capacity_factor,
           "f32_params_per_node": sum(x.numel() for x in leaves
                                      if x.dtype == torch.float32),
           "dtypes": sorted({str(x.dtype) for x in leaves})}
    del leaves
    fleet = FleetScheduler(
        cfg, tree_util.tree_map(lambda x: x.unsqueeze(0).expand(
            (n,) + x.shape), first),
        n_nodes=n, n_slots=SERVE_SLOTS, max_seq=max_seq, prefill_chunk=8)
    del first
    for i in range(1, n):
        fleet.swap_node(i, init_params(
            torch.Generator(device=dev).manual_seed(i), cfg))
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    res["build_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["plane_dtype"] = str(fleet.plane.dtype).replace("torch.", "")
    res["plane_bytes"] = fleet.plane.numel() * fleet.plane.element_size()
    log(f"{cfg.name} fleet of {n}: {res['plane_dtype']} plane of "
        f"{res['plane_bytes']} bytes, {per_node} parameters in "
        f"{res['leaves']} leaves a node, built in "
        f"{res['init_and_pack_s']:.1f} s at a peak of "
        f"{res['build_peak_memory_gb']:.2f} GB")
    return fleet, res


def dropless_gate(label, kern, dec, tol=MOE_VS_DECODE_TOL):
    """At a dropless capacity the kernel prefill and the decode path
    compute one function: their last-position logits within ``tol``, and
    the same argmax wherever the kernel logits' top-2 margin exceeds
    twice it (near-ties counted)."""
    import torch

    diff = float((kern - dec).abs().max())
    margin = top2_margin(kern).reshape(-1)
    same = (torch.argmax(kern, -1) == torch.argmax(dec, -1)).reshape(-1)
    gated = margin > 2 * tol
    ok = diff <= tol and bool(same[gated].all())
    log(f"{label}: dropless kernel prefill vs decode-path logits {diff:.4g} "
        f"<= {tol}; argmax equal for {int(same[gated].sum())} of "
        f"{int(gated.sum())} gated (top-2 margin > 2 x {tol}), "
        f"{int((~gated).sum())} near-ties not gated: "
        f"{'held' if ok else 'FAILED'}")
    return {"kernel_vs_decode_max_abs": diff, "gated": int(gated.sum()),
            "near_ties": int((~gated).sum()), "ok": ok}


def run_moe(dev, arch, cfg=None, n=MOE_NODES, prompt_len=PROMPT_LEN,
            new_tokens=NEW_TOKENS, long_len=LONG_PREFILL, full=True,
            cut=None):
    """Phase 16: the serving tier over a MoE model at full width, cut in
    depth (``MOE_CUTS``), n nodes in one plane.  At the published
    capacity factor: served waves (``full``: a second wave into re-used
    slots against a fresh scheduler), each first token the decode path's
    argmax, the kernel prefill (one attention launch a layer for the
    fleet) against the plain chunked one with routing flips counted,
    and ``swap_node``; at a dropless factor (E / k) the kernel prefill
    against the decode path, before and after the swap.  ``full`` adds
    the long prefill, the decode step's times and the MoE block's parts
    at prefill and decode.  Gates are collected and asserted at the end,
    so one run prints every number."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.kernels import mla_attention as tm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tt
    from repro_torch.serving.scheduler import FleetScheduler, Request
    from repro_torch.serving.serve_step import (
        make_cache,
        make_fleet_decode_step,
        make_forward_prefill,
    )

    cut = cut or MOE_CUTS[arch]
    cfg = cfg or dataclasses.replace(get_config(arch),
                                     n_layers=cut["layers"])
    assert cfg.is_moe and cfg.n_layers > tt.n_dense_layers(cfg)
    dropless = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    log(f"{cfg.name}: reduced {json.dumps(cut['reduced'])}")
    max_seq = prompt_len + new_tokens + 1
    fleet, res = moe_fleet(cfg, n, dev, max_seq, cut)
    gates, peaks = [], {"build": res["build_peak_memory_gb"]}

    def stage(name):
        """The peak allocated memory since the last stage, in GB."""
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(5)
    shape = (n, SERVE_SLOTS, prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, size=shape)
    with RouteLog() as served:
        reqs, steps, secs = serve_wave(fleet, prompts, 0, new_tokens)
    res.update({"requests": len(reqs), "scheduler_steps": steps,
                "first_wave_s": secs,
                "served_dropped_share": served.dropped_share()})
    del served
    # the served rate: MOE_RATE_WAVES more waves, outside the recorder,
    # each timed alone (their prompts from a generator of their own, so
    # every gate below sees the inputs it saw before)
    rate_rng = np.random.default_rng(7)
    waves = []
    for w in range(MOE_RATE_WAVES):
        done, w_steps, w_secs = serve_wave(
            fleet, rate_rng.integers(0, cfg.vocab_size, size=shape),
            1000 + w * len(reqs), new_tokens)
        waves.append({"steps": w_steps, "s": w_secs,
                      "tokens_per_s": len(done) * new_tokens / w_secs})
    rates = sorted(w["tokens_per_s"] for w in waves)
    res.update({"rate_waves": waves,
                "generated_tokens_per_s": statistics.median(rates),
                "generated_tokens_per_s_spread": (rates[-1] - rates[0])
                / statistics.median(rates)})
    log(f"{cfg.name} served {len(reqs)} requests in {steps} steps "
        f"({secs:.3f} s, warming up); then {MOE_RATE_WAVES} waves of "
        f"{len(reqs)} requests: median {res['generated_tokens_per_s']:.2f} "
        f"tok/s (waves {', '.join(f'{r:.2f}' for r in rates)}; spread "
        f"{100 * res['generated_tokens_per_s_spread']:.1f}% of the "
        f"median); dropped (token, slot) pairs in the first wave's steps "
        f"(cap {moe_lib.capacity(cfg, SERVE_SLOTS)} for {SERVE_SLOTS} "
        f"lanes): {100 * res['served_dropped_share']:.2f}%")

    if full:
        # a second wave into the freed slots, against a fresh scheduler
        prompts2 = rng.integers(0, cfg.vocab_size, size=shape)
        reused, _, res["reused_serve_s"] = serve_wave(fleet, prompts2, 100,
                                                      new_tokens)
        params = fleet.layout.unpack(fleet.plane)
        # the f32 leaves are views of the plane: copy them, so the old
        # plane goes with the old scheduler
        params = tree_util.tree_map(
            lambda x: x.clone() if x.dtype == fleet.plane.dtype else x,
            params)
        del fleet
        torch.cuda.empty_cache()
        fleet = FleetScheduler(cfg, params, n_nodes=n, n_slots=SERVE_SLOTS,
                               max_seq=max_seq, prefill_chunk=8)
        del params
        torch.cuda.empty_cache()
        first, _, _ = serve_wave(fleet, prompts2, 100, new_tokens)
        same = [r.output for r in reused] == [r.output for r in first]
        gates.append(("readmission_equal", same))
        res["readmission_equal"] = same
        log(f"{cfg.name} re-admission: the {len(reused)} requests of the "
            f"second wave {'==' if same else '!='} the same prompts on a "
            f"fresh FleetScheduler, token for token")
        del first, reused

    stage("serve_waves")
    # the kernel prefill (one attention launch a layer, whole fleet)
    # against the plain chunked prefill, at the published factor
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    kern_prefill = make_forward_prefill(cfg, tt.ForwardOptions(
        attn_impl="pallas"))
    wrapper = tm.mla_attention if cfg.use_mla else tf.flash_attention
    before = wrapper.launches
    tc_before = (tm.mla_attention.kernel_launches["mla_tc_kernel"]
                 if cfg.use_mla else 0)
    with RouteLog() as kern_routes:
        kern = kern_prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = wrapper.launches - before
    gates.append(("prefill_launches", launches == cfg.n_layers))
    if cfg.use_mla:   # a bf16 latent: every launch the tensor-core kernel
        gates.append(("prefill_tc_kernel", tm.mla_attention.kernel_launches[
            "mla_tc_kernel"] - tc_before == launches))
    with RouteLog() as plain_routes:
        plain = make_forward_prefill(cfg, tt.ForwardOptions(
            attn_impl="chunked"))(params, {"tokens": toks})
    gates.append(("plain_prefill_launches",
                  wrapper.launches - before == launches))
    # at a dropless factor, the kernel prefill (held to the decode path
    # below, once the unpacked params are freed), and the MoE block on
    # its last MoE layer's input against the plain version
    with RouteLog(keep_last=True) as dl_routes:
        kern_dl = make_forward_prefill(dropless, tt.ForwardOptions(
            attn_impl="pallas"))(params, {"tokens": toks})
    block = res["moe_block_vs_plain"] = moe_block_check(dropless,
                                                        *dl_routes.last)
    del dl_routes, params
    torch.cuda.empty_cache()
    gates.append(("moe_block_vs_plain", block["rel_err"] <= MOE_BLOCK_REL_TOL))
    for kind in ("route", "gate"):
        gates.append((f"planted_{kind}_fault_fails_the_block_gate",
                      block[f"planted_{kind}_rel_err"] > MOE_BLOCK_REL_TOL))
    log(f"{cfg.name} MoE block (dropless, the prefill's last MoE layer) vs "
        f"plain_moe: relative error {block['rel_err']:.4g} <= "
        f"{MOE_BLOCK_REL_TOL}; planted route fault "
        f"{block['planted_route_rel_err']:.4g}, gate fault "
        f"{block['planted_gate_rel_err']:.4g} (each must exceed it)")
    gates.append(("finite", bool(torch.isfinite(kern).all())
                  and kern.shape == (n, SERVE_SLOTS, cfg.vocab_size)))
    flips, agree = route_agreement(kern_routes, plain_routes)
    last_agree = agree.reshape(n, SERVE_SLOTS, prompt_len)[..., -1]
    vs_plain = float((kern - plain).abs()[last_agree].max()) \
        if bool(last_agree.any()) else float("nan")
    res.update({"prefill_launches": launches,
                "prefill_dropped_share": kern_routes.dropped_share(),
                "kernel_vs_plain_route_flip_share": flips,
                "last_positions_agreeing": int(last_agree.sum()),
                "kernel_vs_plain_max_abs": vs_plain,
                "kernel_vs_plain_max_abs_all": float(
                    (kern - plain).abs().max()),
                "max_abs_logit": float(kern.abs().max())})
    gates.append(("route_flips", flips <= MOE_FLIP_SHARE_MAX))
    gates.append(("kernel_vs_plain", bool(last_agree.any())
                  and vs_plain <= MOE_VS_PLAIN_TOL))
    log(f"{cfg.name} prefill: {launches} {wrapper.__name__} launch(es); "
        f"routing flips kernel vs plain {100 * flips:.3f}% of (token, "
        f"slot) pairs (<= {100 * MOE_FLIP_SHARE_MAX}%); logits at the "
        f"{int(last_agree.sum())} of {last_agree.numel()} last positions "
        f"whose routing agrees {vs_plain:.4g} <= {MOE_VS_PLAIN_TOL} (all: "
        f"{res['kernel_vs_plain_max_abs_all']:.4g}; max |logit| "
        f"{res['max_abs_logit']:.4g}); dropped pairs in the prefill "
        f"(cap {moe_lib.capacity(cfg, SERVE_SLOTS * prompt_len)}) "
        f"{100 * res['prefill_dropped_share']:.2f}%")
    del plain, kern_routes, plain_routes
    # the served first tokens are the scheduler's own arithmetic at 1.25
    dec = decode_path_logits(cfg, fleet, toks)
    res["first_token"] = decode_path_gate(f"{cfg.name} serving", reqs, kern,
                                          dec)
    # at a dropless factor, the kernel prefill against the decode path
    dec_dl = decode_path_logits(dropless, fleet, toks)
    res["dropless"] = dropless_gate(f"{cfg.name} serving", kern_dl, dec_dl)
    gates.append(("dropless_kernel_vs_decode", res["dropless"]["ok"]))
    # what the dropless gate reads on a decode path with a planted
    # routing fault (which it must fail) and gate fault (printed: the
    # block gate above holds the gates)
    planted = {}
    for kind in ("route", "gate"):
        with PlantedFault(kind):
            bad = decode_path_logits(dropless, fleet, toks)
        planted[kind] = {
            "max_abs": float((kern_dl - bad).abs().max()),
            "argmax_changed": int((torch.argmax(bad, -1)
                                   != torch.argmax(dec_dl, -1)).sum())}
        del bad
    gates.append(("planted_route_fault_fails_the_dropless_gate",
                  planted["route"]["max_abs"] > MOE_VS_DECODE_TOL))
    res["planted_faults"] = planted
    log(f"{cfg.name} planted faults on the decode path against the "
        f"dropless gate's {MOE_VS_DECODE_TOL}: " + ", ".join(
            f"{k} {v['max_abs']:.4g} ({v['argmax_changed']} of "
            f"{n * SERVE_SLOTS} argmax moved)" for k, v in planted.items())
        + " (the route fault must exceed it)")
    del kern, dec, kern_dl, dec_dl

    if full:
        # one long prefill, B = 1 per node, profiled for the attention
        # kernel's share of the device time
        from torch.profiler import ProfilerActivity, profile

        params = fleet.layout.unpack(fleet.plane)
        long_toks = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(n, 1, long_len)), device=dev)
        kern_prefill(params, {"tokens": long_toks[:, :, :256]})  # warm up
        stage("prefill_gates")
        before = wrapper.launches
        with RouteLog(keep_last=True) as long_routes:
            t0 = time.perf_counter()
            out = kern_prefill(params, {"tokens": long_toks})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        gates.append(("long_prefill_launches",
                      wrapper.launches - before == cfg.n_layers))
        gates.append(("long_prefill_finite", bool(torch.isfinite(out).all())))
        stage("long_prefill")
        peak = peaks["long_prefill"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern_prefill(params, {"tokens": long_toks})
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        attn = sum(e.self_device_time_total for e in events
                   if "mla_tc_kernel" in e.key or "flash_tc_kernel" in e.key
                   ) / 1e3
        p_long, t_long = long_routes.last
        res["long_prefill"] = {
            "tokens": n * long_len, "s": secs,
            "tokens_per_s": n * long_len / secs, "peak_memory_gb": peak,
            "device_busy_ms": busy, "attention_kernel_ms": attn,
            "attention_kernel_share_of_busy": attn / busy,
            "attention_kernel_share_of_wall": attn / (secs * 1e3),
            "dropped_share": long_routes.dropped_share(),
            "moe_block": moe_part_ms(cfg, p_long, t_long)}
        del out, long_routes, p_long, t_long, params
        lp = res["long_prefill"]
        log(f"{cfg.name} long prefill {n} x {long_len}: "
            f"{lp['tokens_per_s']:.1f} tok/s, the attention kernel "
            f"{100 * lp['attention_kernel_share_of_busy']:.1f}% of "
            f"{busy:.4g} device ms; dropped pairs "
            f"{100 * lp['dropped_share']:.2f}%; MoE block per layer "
            f"{json.dumps({k: round(v, 4) for k, v in lp['moe_block']['ms'].items()})}"
            f" ms, expert products {lp['moe_block']['expert_tflops']:.1f} "
            f"TFLOP/s ({100 * lp['moe_block']['expert_share_of_bf16_peak']:.1f}%"
            f" of the bf16 peak); peak {peak:.2f} GB")
        torch.cuda.empty_cache()

    stage("long_prefill_profile_and_parts" if full else "prefill_gates")
    if full:
        # the fleet decode step at a short context, and the MoE block's
        # parts on one decode step's tokens (every lane of a node)
        res["fleet_decode_step"] = decode_step_times(cfg, fleet, max_seq=128,
                                                     position=81)
        unpack_ms = unpack_device_ms(fleet.layout, fleet.plane)
        step = res["fleet_decode_step"]
        res["unpack_device_ms"] = unpack_ms
        res["unpack_share_of_step"] = unpack_ms / step["device_busy_ms"]
        cache = make_cache(cfg, n, SERVE_SLOTS, 128, dev)
        cache["position"].fill_(81)
        with RouteLog(keep_last=True) as dec_routes:
            make_fleet_decode_step(cfg, fleet.layout)(
                fleet.plane, torch.zeros((n, SERVE_SLOTS, 1), dtype=torch.int32,
                                         device=dev), cache)
        p_dec, t_dec = dec_routes.last
        del cache, dec_routes
        torch.cuda.empty_cache()
        res["decode_moe_block"] = moe_part_ms(cfg, p_dec, t_dec)
        del p_dec, t_dec
        db = res["decode_moe_block"]
        log(f"{cfg.name} decode step at position 81: host "
            f"{step['host_ms']:.4g} ms, device {step['device_busy_ms']:.4g} ms "
            f"(idle {100 * step['device_idle_share']:.1f}%), bound "
            f"{step['bound_ms']:.4g} ms; the plane's unpack casts "
            f"{unpack_ms:.4g} ms ({100 * res['unpack_share_of_step']:.1f}%); "
            f"MoE block per layer "
            f"{json.dumps({k: round(v, 4) for k, v in db['ms'].items()})} ms "
            f"(cap {db['cap']}), expert products {db['expert_tflops']:.2f} "
            f"TFLOP/s")
        torch.cuda.empty_cache()
        stage("decode")

    # swap node 1's row for an init no node has: its own prefill (from the
    # init itself) against the fleet's decode path (from the plane row),
    # at a dropless factor; the new requests' first tokens at 1.25
    other = tt.init_params(torch.Generator(device=dev).manual_seed(n), cfg)
    new_prompts = rng.integers(0, cfg.vocab_size, size=(SERVE_SLOTS,
                                                        prompt_len))
    nt = torch.zeros_like(toks)
    nt[1] = torch.as_tensor(new_prompts, device=dev)
    kern_dl = make_forward_prefill(dropless, tt.ForwardOptions(
        attn_impl="pallas"))(tt.add_node_axis(other), {"tokens": nt[1:2]})[0]
    ptr = fleet.plane.data_ptr()
    fleet.swap_node(1, other)
    head = next(sl for (path, _), sl in zip(
        tree_util.leaves_with_paths(other), fleet.layout.slots)
        if path == ("head",))
    gates.append(("swap_in_place", fleet.plane.data_ptr() == ptr
                  and torch.equal(
                      fleet.plane[1, head.offset:head.offset + head.size],
                      other["head"].reshape(-1).to(fleet.plane.dtype))))
    del other
    torch.cuda.empty_cache()
    reqs = [Request(rid=200 + j, prompt=new_prompts[j].tolist(), max_new=4)
            for j in range(SERVE_SLOTS)]
    for r in reqs:
        fleet.submit(r, node=1)
    fleet.run_until_drained()
    dec = decode_path_logits(cfg, fleet, nt)[1]
    res["swap_first_token"] = decode_path_gate(f"{cfg.name} swap_node", reqs,
                                               kern_dl, dec)
    dec_dl = decode_path_logits(dropless, fleet, nt)[1]
    res["swap_dropless"] = dropless_gate(f"{cfg.name} swap_node", kern_dl,
                                         dec_dl)
    gates.append(("swap_dropless_kernel_vs_decode",
                  res["swap_dropless"]["ok"]))
    del fleet, kern_dl, dec, dec_dl
    torch.cuda.empty_cache()
    stage("swap")
    res["peak_memory_gb_by_stage"] = peaks
    res["peak_memory_gb"] = max(peaks.values())
    res["gates"] = {name: ok for name, ok in gates}
    log(f"serving_moe {cfg.name} " + json.dumps(res))
    failed = [name for name, ok in gates if not ok]
    assert not failed, (cfg.name, failed)
    return res


def run_moe_cli(dev):
    """The serve CLI on llama4-scout at full width, ``--layers 1``, n = 2:
    one wave of 64-token prompts, 16 tokens each, from its own fleet."""
    import torch

    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    reqs = serve.main(["--arch", "llama4-scout-17b-a16e", "--layers", "1",
                       "--nodes", str(MOE_NODES), "--batch", str(SERVE_SLOTS),
                       "--prompt-len", str(PROMPT_LEN), "--new-tokens",
                       str(NEW_TOKENS), "--device", str(dev)])
    gc.collect()
    torch.cuda.empty_cache()
    assert len(reqs) == MOE_NODES * SERVE_SLOTS and all(
        r.done and len(r.output) == NEW_TOKENS for r in reqs), reqs
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve CLI --arch llama4-scout-17b-a16e --layers 1: {len(reqs)} "
        f"requests of {NEW_TOKENS} tokens served; peak {peak:.2f} GB")
    return {"requests": len(reqs), "peak_memory_gb": peak}


def run_moe_phase(dev):
    """Phase 16: deepseek-v2 (2 layers, the full set), llama4-scout (1 MoE
    layer: the waves, the prefill gates and one swap), and the serve CLI
    on llama4-scout's cut."""
    res = {"deepseek": run_moe(dev, "deepseek-v2-236b"),
           "llama4": run_moe(dev, "llama4-scout-17b-a16e", full=False),
           "cli": run_moe_cli(dev)}
    res["peak_memory_gb"] = max(r["peak_memory_gb"] for r in res.values())
    return res


# ----------------------------------------------------------------------
# phase 17: the rest of the zoo — hymba-1.5b, the frontends, temperature
# ----------------------------------------------------------------------
HYBRID_NODES = 4
HYBRID_BUDGET_S = 180
# per node, the reference's tree (tests/test_torch_hybrid.py holds the
# port's to it): 19 leaves, three of them f32 (dt_bias, log_a, d_skip)
HYBRID_CUT = {"params": 1_641_681_600, "leaves": 19,
              "f32_params": 1_843_200, "reduced": {}}
# each layer's attention output through the flash kernel against the
# same layer's einsum attention on the same input (the plain path's
# hidden state), relative Frobenius error (bf16 outputs rounded on both
# sides): pinned from a run on an H100 SXM (700 W) that measured 2.0e-4
# to 3.3e-4 over the 32 layers
HYBRID_LAYER_REL_TOL = 2e-3
HYBRID_CUT_LAYERS = 2
# the kernel prefill's last-position logits against the decode path's
# (phase 8's bound, two bf16 ulps at |logit| in [4, 8)), at full depth
# and on the 2-layer cut: the same card measured 0.0547 at full depth
# (max |logit| 4.75) and 0.0313 on the cut (4.41), so full depth is gated
HYBRID_VS_DECODE_TOL = 0.0625
TEMPERATURE = 0.8
FRONTENDS = {"internvl2-1b": {"params": 630_553_728, "leaves": 13},
             "musicgen-medium": {"params": 1_365_740_544, "leaves": 15}}
FRONTEND_BATCH = 2             # (2, 4096) forward a frontend
# internvl2-1b's train step: n = 2, as n = 4 does not fit the card in
# eager PyTorch: AdamW behind the nonfinite guard holds ~10 f32 copies
# of the nodes' 630.6 M parameters a node at its peak (the old and new
# moments, the gradient sums, the zero-substituted gradients, the
# updates), 2.5 GB each a node; n = 4 ran out of the 80 GB (PERF.md)
TRAIN_NODES, TRAIN_MICRO, TRAIN_LOCAL, TRAIN_SEQ, TRAIN_STEPS = 2, 1, 2, 512, 3


def hybrid_layer(cfg, lp, x, positions, window, opts):
    """One hybrid layer of every node (``forward_nodes``'s body): the
    norm, attention by ``opts`` and the Mamba block on it, averaged, then
    the MLP.  Returns (the layer's output, its attention output)."""
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import norm_apply

    h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
    a = tt._attn_block(lp, cfg, h, positions, window, opts)
    x = x + tt._mixer(lp, cfg, h, a)[0]
    return x + tt._ffn_block(lp, cfg, x, False)[0], a


def hybrid_layer_errors(cfg, params, toks):
    """Each hybrid layer's attention output through the flash kernel
    against einsum attention on the same input (the plain path's hidden
    state): the relative Frobenius error of each layer.  Beside it, the
    kernel path's own hidden state carried through the layers against the
    plain path's (not gated: a random init grows a last-bit difference
    layer by layer).  Its flash launches compare the kernel with the
    einsum path, so they are taken back out of the count."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import norm_apply

    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())
    launches, shapes = fa.flash_attention.launches, dict(
        fa.flash_attention.shapes)
    flash, plain = (tt.ForwardOptions(attn_impl=i)
                    for i in ("pallas", "einsum"))
    positions = torch.arange(toks.shape[-1], device=toks.device)
    windows = tt._layer_windows(cfg)
    x = xk = tt._embed_inputs(params, cfg, toks)
    local, carried = [], []
    for i, lp, _ in tt._layers(params, cfg):
        h = norm_apply(cfg.norm_kind, lp["norm1"], x, cfg.norm_eps)
        ak = tt._attn_block(lp, cfg, h, positions, windows[i], flash)
        x, ap = hybrid_layer(cfg, lp, x, positions, windows[i], plain)
        local.append(rel(ak, ap))
        xk, _ = hybrid_layer(cfg, lp, xk, positions, windows[i], flash)
        carried.append(rel(xk, x))
    assert fa.flash_attention.launches - launches == 2 * cfg.n_layers
    fa.flash_attention.launches = launches
    fa.flash_attention.shapes.clear()
    fa.flash_attention.shapes.update(shapes)
    return local, carried


def timed_scan():
    """Wrap ``models.ssm._mamba_scan`` so each call's wall time (between
    two synchronizations) is recorded; returns the list and an undo."""
    import torch

    from repro_torch.models import ssm as ssm_lib

    orig, secs = ssm_lib._mamba_scan, []

    def wrapped(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        return out

    ssm_lib._mamba_scan = wrapped
    return secs, lambda: setattr(ssm_lib, "_mamba_scan", orig)


def kernel_ms(events, *needles):
    """Device ms and count of the profiled kernels whose name holds any
    of ``needles``; each matched name is logged with its count."""
    hit = [e for e in events if any(n in e.key for n in needles)]
    for e in hit:
        log(f"profiled kernel {e.key[:120]!r}: {e.count} calls, "
            f"{e.self_device_time_total / 1e3:.3f} ms")
    return (sum(e.self_device_time_total for e in hit) / 1e3,
            sum(e.count for e in hit))


def hybrid_long_prefill(cfg, params, long_toks):
    """(b): the (n, S) prefill through ``forward_nodes(attn_impl=
    "pallas")``, one flash launch a layer: its wall time after a warm-up
    at full length, then with each Mamba scan timed between
    synchronizations, their share of the wall.  The device's time, per
    kind of layer: one local and one global layer run alone on the
    prefill's hidden state under ``torch.profiler`` (all of the layer's
    kernels, flash's, and the Mamba loop's ``addcmul``), summed over the
    layers of each kind; the embedding and the head are left out.  A
    profile of the whole prefill would record its 131,072 loop launches,
    whose processing takes tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt
    from repro_torch.serving.serve_step import make_forward_prefill

    prefill = make_forward_prefill(cfg, tt.ForwardOptions(attn_impl="pallas"))
    n, _, s = long_toks.shape
    prefill(params, {"tokens": long_toks})             # warm up, full length
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fa.flash_attention.launches
    t0 = time.perf_counter()
    out = prefill(params, {"tokens": long_toks})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert fa.flash_attention.launches - before == cfg.n_layers
    assert bool(torch.isfinite(out).all()) and out.shape == (
        n, 1, cfg.vocab_size)
    res = {"tokens": n * s, "s": secs, "tokens_per_s": n * s / secs,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del out
    scans, undo = timed_scan()
    try:
        t0 = time.perf_counter()
        prefill(params, {"tokens": long_toks})
        torch.cuda.synchronize()
        synced = time.perf_counter() - t0
    finally:
        undo()
    assert len(scans) == cfg.n_layers, len(scans)
    res.update({"mamba_scan_wall_s": sum(scans), "synced_run_s": synced,
                "mamba_scan_share_of_wall": sum(scans) / synced})

    kinds = cfg.layer_kinds()
    windows = tt._layer_windows(cfg)
    positions = torch.arange(s, device=long_toks.device)
    x = tt._embed_inputs(params, cfg, long_toks)
    device = {"busy": 0.0, "flash": 0.0, "addcmul": 0.0}
    per_kind = {}
    for kind in ("local", "global"):
        i = kinds.index(kind)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hybrid_layer(cfg, tt._layer(params["dense_layers"], i), x,
                         positions, windows[i], tt.ForwardOptions(
                             attn_impl="pallas"))
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events) / 1e3
        fl_ms, fl_n = kernel_ms(events, "flash")
        sc_ms, sc_n = kernel_ms(events, "addcmul")
        assert fl_n == 1 and sc_n == s, (kind, fl_n, sc_n)
        count = kinds.count(kind)
        per_kind[kind] = {"layers": count, "busy_ms": busy, "flash_ms": fl_ms,
                          "addcmul_ms": sc_ms}
        for key, v in (("busy", busy), ("flash", fl_ms), ("addcmul", sc_ms)):
            device[key] += count * v
    del x
    res.update({
        "layers_device_ms": device["busy"], "per_layer_kind": per_kind,
        "device_idle_share": max(0.0, 1 - device["busy"] / (secs * 1e3)),
        "flash_device_ms": device["flash"],
        "flash_share_of_device": device["flash"] / device["busy"],
        "mamba_loop_device_ms": device["addcmul"],
        "mamba_loop_share_of_device": device["addcmul"] / device["busy"]})
    log(f"hymba-1.5b prefill {n} x {s}: {secs:.3f} s "
        f"({res['tokens_per_s']:.0f} tok/s); the Mamba scans take "
        f"{sum(scans):.3f} s of a {synced:.3f} s synchronized run "
        f"({100 * res['mamba_scan_share_of_wall']:.1f}%); the layers' device "
        f"time (one local and one global layer profiled, times their "
        f"counts) {device['busy']:.1f} ms (idle "
        f"{100 * res['device_idle_share']:.1f}%): flash {device['flash']:.1f}"
        f" ms ({100 * res['flash_share_of_device']:.1f}%), the Mamba loop's "
        f"addcmul {device['addcmul']:.1f} ms "
        f"({100 * res['mamba_loop_share_of_device']:.1f}%); peak "
        f"{res['peak_memory_gb']:.2f} GB")
    return res


def run_hybrid_cut(dev, cfg, n, prompts, new_tokens):
    """(c), (f): hymba-1.5b at full width cut to ``HYBRID_CUT_LAYERS``
    layers (bf16, n distinct inits): a served wave's first tokens, the
    kernel prefill (one flash launch a layer) against the decode path
    under ``HYBRID_VS_DECODE_TOL`` and each first token against both
    argmaxes (``first_token_gate``); then node 0's ``greedy_generate`` at
    ``TEMPERATURE`` with a key: the same key twice gives the same tokens,
    every token lies in the vocabulary, a second key is logged."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core import prng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.scheduler import FleetScheduler
    from repro_torch.serving.serve_step import (
        greedy_generate,
        make_forward_prefill,
    )

    cut = dataclasses.replace(cfg, n_layers=HYBRID_CUT_LAYERS)
    reduced_line(17, "serving_hymba", "layers (the gates of (c), (f))",
                 cfg.n_layers, cut.n_layers)
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[init_params(torch.Generator(device=dev).manual_seed(i), cut)
          for i in range(n)])
    fleet = FleetScheduler(cut, stacked, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=prompts.shape[-1] + new_tokens + 1,
                           prefill_chunk=8)
    del stacked
    reqs, _, _ = serve_wave(fleet, prompts, 300, new_tokens)
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    before = fa.flash_attention.launches
    kern = make_forward_prefill(cut, ForwardOptions(attn_impl="pallas"))(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == cut.n_layers
    dec = decode_path_logits(cut, fleet, toks)
    res = {"layers": cut.n_layers, "nodes": n,
           "max_abs_logit": float(kern.abs().max()),
           "first_token": first_token_gate(
               f"hymba-1.5b cut to {cut.n_layers} layers", reqs, kern, dec,
               HYBRID_VS_DECODE_TOL)}
    del kern, dec

    one = tree_util.tree_map(lambda a: a[0], params)
    prompt = toks[0]                                    # (B, S)
    draw = lambda seed: greedy_generate(
        cut, one, prompt, new_tokens, temperature=TEMPERATURE,
        rng=prng.key(seed))
    t0 = time.perf_counter()
    first = draw(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    again, other = draw(0), draw(1)
    greedy = greedy_generate(cut, one, prompt, new_tokens)
    new = lambda t: t[:, prompt.shape[1]:].tolist()
    assert torch.equal(first, again), "one key drew two samples"
    assert int(first.min()) >= 0 and int(first.max()) < cut.vocab_size
    assert int(other.min()) >= 0 and int(other.max()) < cut.vocab_size
    res["temperature"] = {
        "temperature": TEMPERATURE, "key0": new(first), "key1": new(other),
        "greedy": new(greedy), "key0_twice_equal": True,
        "keys_differ": not torch.equal(first, other),
        "s_per_generate": secs}
    log("hymba-1.5b temperature " + json.dumps(res["temperature"]))
    del fleet, params, one
    torch.cuda.empty_cache()
    return res


def run_hymba(dev, cfg=None, n=HYBRID_NODES, prompt_len=PROMPT_LEN,
              new_tokens=NEW_TOKENS, long_len=LONG_PREFILL,
              decode_context=DECODE_CONTEXT, cut=None):
    """Phase 17 (a)–(d): hymba-1.5b at full size, n nodes in one f32
    plane: a warm-up wave, a second wave into the used slots held token
    for token to the same prompts on a fresh ``FleetScheduler`` (the
    served rate is the median of those two timed waves); per
    layer the flash attention against einsum attention; the full-depth
    kernel prefill against the decode path (``first_token_gate``); the
    2-layer cut's gates and temperature sampling; the (n, 4096)
    prefill's split; the decode step at positions 81 and 4088 with the
    unpack casts' share; peak memory; the seconds of each part."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import ForwardOptions
    from repro_torch.serving.scheduler import FleetScheduler
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or get_config("hymba-1.5b")
    cut = cut or HYBRID_CUT
    max_seq = prompt_len + new_tokens + 1
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    torch.cuda.reset_peak_memory_stats()
    fleet, res = moe_fleet(cfg, n, dev, max_seq, cut)
    assert res["f32_params_per_node"] == cut["f32_params"], res
    assert res["plane_dtype"] == "float32", res
    res["kinds"] = list(cfg.layer_kinds())
    rng = np.random.default_rng(7)
    shape = (n, SERVE_SLOTS, prompt_len)
    prompts = rng.integers(0, cfg.vocab_size, size=shape)
    warm, _, _ = serve_wave(fleet, prompts, 0, new_tokens)    # warm up
    prompts2 = rng.integers(0, cfg.vocab_size, size=shape)
    reused, _, wave_s = serve_wave(fleet, prompts2, 100, new_tokens)
    waves = [wave_s]
    lap("build_and_two_waves")
    # the unpacked f32 leaves are views of the plane: copy them, so the
    # old plane is freed before the fresh scheduler packs its own
    params = tree_util.tree_map(
        lambda t: t.clone() if t.dtype == torch.float32 else t,
        fleet.layout.unpack(fleet.plane))
    del fleet
    torch.cuda.empty_cache()
    fleet = FleetScheduler(cfg, params, n_nodes=n, n_slots=SERVE_SLOTS,
                           max_seq=max_seq, prefill_chunk=8)
    del params
    torch.cuda.empty_cache()
    first, _, wave_s = serve_wave(fleet, prompts2, 100, new_tokens)
    waves.append(wave_s)
    assert [r.output for r in reused] == [r.output for r in first], \
        "a re-used hybrid slot served other tokens than a fresh scheduler"
    res["readmission_equal"] = len(reused)
    log(f"hymba-1.5b re-admission: the {len(reused)} requests of the "
        f"second wave == the same prompts on a fresh FleetScheduler, token "
        f"for token")
    lap("fresh_scheduler_and_its_wave")
    per_wave = n * SERVE_SLOTS * new_tokens
    res.update({"wave_s": waves, "tokens_per_wave": per_wave,
                "generated_tokens_per_s": per_wave / statistics.median(
                    waves)})
    log(f"hymba-1.5b served: {per_wave} tokens a wave, waves "
        f"{[round(w, 3) for w in waves]} s, median rate "
        f"{res['generated_tokens_per_s']:.1f} tok/s")

    # (c) per layer, flash against einsum attention; the full depth's
    # first tokens against the decode path
    params = fleet.layout.unpack(fleet.plane)
    toks = torch.as_tensor(prompts, device=dev)
    local, carried = hybrid_layer_errors(cfg, params, toks)
    worst = max(local)
    before = fa.flash_attention.launches
    kern = make_forward_prefill(cfg, ForwardOptions(attn_impl="pallas"))(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches - before
    assert launches == cfg.n_layers, launches
    assert bool(torch.isfinite(kern).all())
    res.update({"prefill_launches": launches, "layer_rel_err_max": worst,
                "layer_rel_err": local, "carried_rel_diff": carried})
    log(f"hymba-1.5b prefill: {launches} flash launches; per layer, flash "
        f"vs einsum attention on the same input: relative error <= "
        f"{worst:.3g} (gate {HYBRID_LAYER_REL_TOL}); carried through the "
        f"layers (not gated): {depth_samples(carried)}")
    assert worst <= HYBRID_LAYER_REL_TOL, local
    lap("layer_errors_and_prefill")
    dec = decode_path_logits(cfg, fleet, toks)
    res["first_token"] = first_token_gate(
        "hymba-1.5b full depth", warm, kern, dec, HYBRID_VS_DECODE_TOL)
    res["max_abs_logit"] = float(kern.abs().max())
    del kern, dec, params
    lap("decode_path")
    res["cut"] = run_hybrid_cut(dev, cfg, n, prompts, new_tokens)
    lap("cut_and_temperature")

    # (b) the long prefill, B = 1 per node
    params = fleet.layout.unpack(fleet.plane)
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             size=(n, 1, long_len)),
                                device=dev)
    res["long_prefill"] = hybrid_long_prefill(cfg, params, long_toks)
    del params, long_toks
    torch.cuda.empty_cache()
    lap("long_prefill")

    # (d) the decode step
    res["fleet_decode_step"] = decode_step_times(cfg, fleet, position=81,
                                                 reps=3)
    res["fleet_decode_step_long"] = decode_step_times(
        cfg, fleet, max_seq=decode_context, position=decode_context - 8,
        reps=3)
    unpack_ms = unpack_device_ms(fleet.layout, fleet.plane)
    res["unpack_device_ms"] = unpack_ms
    res["unpack_share_of_step"] = (
        unpack_ms / res["fleet_decode_step"]["device_busy_ms"])
    res["unpack_share_of_step_long"] = (
        unpack_ms / res["fleet_decode_step_long"]["device_busy_ms"])
    log(f"hymba-1.5b decode step: device "
        f"{res['fleet_decode_step']['device_busy_ms']:.4g} ms, host "
        f"{res['fleet_decode_step']['host_ms']:.4g} ms at position 81; "
        f"device {res['fleet_decode_step_long']['device_busy_ms']:.4g} ms,"
        f" host {res['fleet_decode_step_long']['host_ms']:.4g} ms at "
        f"{decode_context - 8}; the plane's unpack casts {unpack_ms:.4g} "
        f"ms ({100 * res['unpack_share_of_step']:.1f}% and "
        f"{100 * res['unpack_share_of_step_long']:.1f}%)")
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lap("decode_steps")
    res["seconds"] = laps
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    log("serving_hymba " + json.dumps(res))
    return res


def run_frontend(dev, arch, cfg=None, seq=LONG_PREFILL, cut=None):
    """(g): a frontend config at full size (bf16, one node): a
    (FRONTEND_BATCH, seq) prefill from seeded stub embeddings through the
    flash kernel (one launch a layer), its last-position logits held to
    the chunked prefill's under ``FLASH_VS_CHUNKED_TOL``."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import (
        ForwardOptions,
        add_node_axis,
        init_params,
    )
    from repro_torch.serving.serve_step import make_forward_prefill

    cfg = cfg or get_config(arch)
    cut = cut or FRONTENDS[arch]
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    leaves = tree_util.leaves(params)
    res = {"arch": cfg.name, "params": sum(x.numel() for x in leaves),
           "leaves": len(leaves), "layers": cfg.n_layers,
           "d_model": cfg.d_model, "frontend_dim": cfg.frontend_dim,
           "batch": FRONTEND_BATCH, "seq": seq}
    assert (res["params"], res["leaves"]) == (cut["params"],
                                              cut["leaves"]), res
    del leaves
    params = add_node_axis(params)
    emb = torch.randn((1, FRONTEND_BATCH, seq, cfg.frontend_dim),
                      generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    out = {}
    for impl in ("pallas", "chunked"):
        prefill = make_forward_prefill(cfg, ForwardOptions(attn_impl=impl))
        before = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[impl] = prefill(params, {"embeddings": emb})
        torch.cuda.synchronize()
        res[f"{impl}_s"] = time.perf_counter() - t0
        res[f"{impl}_launches"] = fa.flash_attention.launches - before
    assert res["pallas_launches"] == cfg.n_layers, res
    assert res["chunked_launches"] == 0, res
    assert bool(torch.isfinite(out["pallas"]).all()) and out[
        "pallas"].shape == (1, FRONTEND_BATCH, cfg.vocab_size)
    diff = float((out["pallas"] - out["chunked"]).abs().max())
    res.update({"flash_vs_chunked_max_abs": diff,
                "max_abs_logit": float(out["pallas"].abs().max())})
    log("frontend " + json.dumps(res))
    assert diff <= FLASH_VS_CHUNKED_TOL, (arch, diff)
    del params, emb, out
    torch.cuda.empty_cache()
    return res


def run_frontend_train(dev, cfg=None, n=TRAIN_NODES, seq=TRAIN_SEQ,
                       steps=TRAIN_STEPS):
    """(g): internvl2-1b's production train step at full size (bf16), n
    distinct inits: ``make_train_step`` at microbatch 1 on stub
    embeddings, AdamW behind the nonfinite guard, gossip by BA(n, 2)'s
    degree matrix (BA(2, 1) at n = 2) through the fused-plane kernel (one
    ``gossip_plane`` launch a step): every loss finite, no step skipped."""
    import math

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.decentralized import round_coeffs
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import (make_train_step,
                                                 reshape_for_microbatch)

    cfg = cfg or get_config("internvl2-1b")
    reduced_line(17, "frontend_train_step", "nodes", 16, n)
    reduced_line(17, "frontend_train_step", "sequence", cfg.max_seq_len,
                 seq)
    # phase 20's dry-run check reads the step's own bytes: everything
    # below is allocated above this baseline (what earlier work left)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[init_params(torch.Generator(device=dev).manual_seed(i), cfg)
          for i in range(n)])
    opt = make_optimizer("adamw", 1e-4, skip_nonfinite=True)
    step = make_train_step(cfg, ParallelConfig(n_nodes=n,
                                               microbatch=TRAIN_MICRO), opt)
    state = opt.init(params)
    # BA(n, 2), or BA(2, 1) at n = 2
    coeffs = torch.as_tensor(round_coeffs(
        barabasi_albert(n, min(2, n - 1), 0), AggregationStrategy("degree"),
        0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = n * TRAIN_MICRO * TRAIN_LOCAL
    before = gm.gossip_plane.launches
    losses, secs = [], []
    for _ in range(steps):
        batch = reshape_for_microbatch({
            "embeddings": torch.randn((rows, seq, cfg.frontend_dim),
                                      generator=gen, device=dev),
            "labels": torch.randint(0, cfg.vocab_size, (rows, seq),
                                    generator=gen, device=dev)},
            n, TRAIN_MICRO)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, coeffs)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    launches = gm.gossip_plane.launches - before
    skipped = state["skipped"].tolist()
    res = {"arch": cfg.name, "nodes": n, "microbatch": TRAIN_MICRO,
           "local_batch": TRAIN_LOCAL * TRAIN_MICRO, "seq": seq,
           "steps": steps, "losses": losses, "s_per_step": secs,
           "skipped": skipped, "gossip_plane_launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "baseline_bytes": base}
    res["step_peak_bytes"] = res["peak_memory_bytes"] - base
    res["peak_memory_gb"] = res["peak_memory_bytes"] / 1e9
    log("frontend_train_step " + json.dumps(res))
    assert all(math.isfinite(x) for x in losses), losses
    assert skipped == [0] * n, skipped
    assert launches == steps, launches
    del params, state, batch
    torch.cuda.empty_cache()
    return res


def run_zoo_phase(dev):
    """Phase 17: hymba-1.5b (a)–(f), the serve CLI on its 2-layer cut
    (e), and the frontends (g)."""
    import torch

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    res = {"hymba": run_hymba(dev)}
    seconds = {"hymba": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    reqs = serve.main(["--arch", "hymba-1.5b", "--layers",
                       str(HYBRID_CUT_LAYERS), "--nodes", str(HYBRID_NODES),
                       "--batch", str(SERVE_SLOTS), "--prompt-len",
                       str(PROMPT_LEN), "--new-tokens", str(NEW_TOKENS),
                       "--device", str(dev)])
    assert len(reqs) == HYBRID_NODES * SERVE_SLOTS and all(
        r.done and len(r.output) == NEW_TOKENS for r in reqs), reqs
    res["cli"] = {"requests": len(reqs),
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"serve CLI --arch hymba-1.5b --layers {HYBRID_CUT_LAYERS}: "
        f"{len(reqs)} requests of {NEW_TOKENS} tokens served")
    gc.collect()
    torch.cuda.empty_cache()
    seconds["cli"] = time.perf_counter() - t0 - sum(seconds.values())
    for arch in FRONTENDS:
        torch.cuda.reset_peak_memory_stats()
        res[arch] = run_frontend(dev, arch)
        res[arch]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    seconds["frontends"] = time.perf_counter() - t0 - sum(seconds.values())
    res["train_step"] = run_frontend_train(dev)
    seconds["train_step"] = time.perf_counter() - t0 - sum(seconds.values())
    res["peak_memory_gb"] = max(r["peak_memory_gb"] for r in res.values())
    log("phase 17 seconds " + json.dumps(seconds))
    return res


# ----------------------------------------------------------------------
# phase 18: the entry points — the sweep CLI, the serving benchmark, the
# serve CLI on phi3-mini-3.8b and starcoder2-7b, the train driver
# ----------------------------------------------------------------------
ENTRY_BUDGET_S = 120
ENTRY_OUT = Path(__file__).resolve().parent / "chiprun_out" / "entry_points"
ENTRY_REQUESTS = 2          # the serving benchmark's requests a node
ENTRY_EDGES_NODES = 64      # the edges preset's graph ("pair with 64+")
# the fig4 preset mixes by einsum, a batched product whose card kernel
# depends on E: the legacy loop's cells (the trainer, one cell a run) part
# from the E = 6 grid on the last bit and, over 6 smoke rounds, by 0.6875
# of 128 eval samples in the final OOD accuracy, 0.17 in an AUC (measured
# on an H100 at 700 W; 0 on the CPU; the engine's E = 1 run before the
# loop was ported gave the same 0.6875).  Phase 14's bit-for-bit bound
# holds for the fused-plane kernel, whose batched launch equals E single
# ones.  Pinned at 2 samples.
ENTRY_LEGACY_DRIFT_SAMPLES = 2.0
# phase 18 (c) and (d): full size, n nodes in one bf16 plane; the flash
# prefill of ``batch`` sequences of LONG_PREFILL on one node
ENTRY_MODELS = {
    "phi3-mini-3.8b": {"nodes": 4, "batch": 4, "params": 3_821_079_552,
                       "leaves": 12},
    "starcoder2-7b": {"nodes": 2, "batch": 2, "params": 7_399_351_296,
                      "leaves": 14},
}
ENTRY_TRAIN = {"arch": "internvl2-1b", "nodes": 2, "rounds": 2, "steps": 2,
               "seq": 512, "batch": 2}


def captured(fn, *args):
    """(return value, standard output) of one call."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue()


def sweep_with_legacy(sweep, argv):
    """``(rows, legacy rows, stdout)`` of one sweep CLI run with its legacy
    baseline."""
    legacy = []
    orig = sweep.run_legacy_baseline

    def keep(*args, **kwargs):
        legacy.extend(orig(*args, **kwargs))
        return legacy

    sweep.run_legacy_baseline = keep
    try:
        rows, text = captured(sweep.main, argv)
    finally:
        sweep.run_legacy_baseline = orig
    return rows, legacy, text


def legacy_drift(rows, legacy, scale):
    """The legacy loop's rows against the grid's in eval samples, held to
    ``ENTRY_LEGACY_DRIFT_SAMPLES``."""
    assert len(rows) == len(legacy)
    drift = {k: max(abs(a[k] - b[k]) * scale.eval_n
                    for a, b in zip(rows, legacy))
             for k in ("iid_auc", "ood_auc", "final_ood_acc_mean")}
    assert max(drift.values()) <= ENTRY_LEGACY_DRIFT_SAMPLES, drift
    return drift


class SummaryHistories:
    """Every history the benchmarks' summaries read
    (``propagation_summary`` in ``benchmarks.common`` and
    ``benchmarks.ablations``), in call order."""

    def __enter__(self):
        from repro_torch.benchmarks import ablations, common

        self.histories, self._orig = [], {}
        for mod in (common, ablations):
            orig = self._orig[mod] = mod.propagation_summary

            def keep(hist, *args, _orig=orig, **kwargs):
                self.histories.append(hist)
                return _orig(hist, *args, **kwargs)

            mod.propagation_summary = keep
        return self

    def __exit__(self, *exc):
        for mod, orig in self._orig.items():
            mod.propagation_summary = orig


def run_entry_sweep(dev, out, full=True, edges_nodes=ENTRY_EDGES_NODES):
    """(a) ``python -m repro_torch.benchmarks.sweep``: ``--list``; fig4's
    ``--full --dry-run`` plan; fig4 ``--full`` at one seed (six
    strategies, n = 33, R = 40) with the paper's claim (aware over
    unaware on average, degree and betweenness each over unweighted), its
    histories kept for phase 22; ``edges`` at the smoke scale on BA(64, 2)
    through ``edges_kernel`` (one batched launch a round) and fig4
    ``--smoke``, each with the legacy baseline, one ``run_experiment`` a
    cell (the trainer's per-round loop; for ``edges`` one
    ``edges_kernel`` launch a cell a round), held to the grid by
    ``ENTRY_LEGACY_DRIFT_SAMPLES``."""
    import numpy as np

    from repro_torch.benchmarks import sweep
    from repro_torch.kernels import gossip_mix as gm

    res = {}
    _, listing = captured(sweep.main, ["--list"])
    assert all(f"  {name:8s} " in listing for name in sweep.PRESETS), listing
    assert len(sweep.PRESETS) == 9
    _, plan = captured(sweep.main, ["--preset", "fig4", "--full",
                                    "--dry-run"])
    log(plan.rstrip())
    assert "total cells: 12 (1 compiled programs)" in plan, plan
    common = ["--datasets", "mnist", "--seeds", "0", "--device", str(dev),
              "--out", str(out)]
    reduced_line(18, "sweep_cli fig4 --full", "seeds", 2, 1)
    t0 = time.perf_counter()
    with SummaryHistories() as grid:
        rows, text = captured(sweep.main, ["--preset", "fig4", "--no-legacy"]
                              + (["--full"] if full else ["--smoke"])
                              + common)
    res["fig4_full_s"] = time.perf_counter() - t0
    # one group, so the summaries ran in the rows' order; phase 22 holds
    # the legacy loop's full-scale degree cell to this row
    assert len(grid.histories) == len(rows)
    HISTORIES["fig4_full"] = {r["strategy"]: h
                              for r, h in zip(rows, grid.histories)}
    log(text.rstrip())
    auc = {r["strategy"]: r["ood_auc"] for r in rows}
    res["fig4_full_ood_auc"] = auc
    aware = np.mean([auc["degree"], auc["betweenness"]])
    unaware = np.mean([v for k, v in auc.items()
                       if k not in ("degree", "betweenness")])
    if full:   # the paper's claim at its scale, both aware kinds
        assert aware > unaware, auc
        assert auc["degree"] > auc["unweighted"], auc
        assert auc["betweenness"] > auc["unweighted"], auc
    reduced_line(18, "sweep_cli edges", "rounds", 30, 6)
    before = gm.gossip_edges.launches
    shapes0 = dict(gm.gossip_edges.shapes)
    t0 = time.perf_counter()
    rows, legacy, text = sweep_with_legacy(
        sweep, ["--preset", "edges", "--smoke", "--n-nodes",
                str(edges_nodes)] + common)
    res["edges_s"] = time.perf_counter() - t0
    res["edges_launches"] = gm.gossip_edges.launches - before
    single = (edges_nodes, FFN_P, "float32")
    res["edges_legacy_launches"] = gm.gossip_edges.shapes.get(
        single, 0) - shapes0.get(single, 0)
    res["edges_ood_auc"] = {r["strategy"]: r["ood_auc"] for r in rows}
    log(text.rstrip())
    # the grid: one batched launch a round; the legacy loop: one launch a
    # cell a round, through the trainer's mix_impl="edges"
    assert res["edges_launches"] == (1 + len(rows)) * sweep.SMOKE.rounds, res
    assert res["edges_legacy_launches"] == len(rows) * sweep.SMOKE.rounds
    res["edges_legacy_drift_eval_samples"] = legacy_drift(rows, legacy,
                                                          sweep.SMOKE)
    t0 = time.perf_counter()
    rows, legacy, text = sweep_with_legacy(
        sweep, ["--preset", "fig4", "--smoke"] + common)
    res["fig4_smoke_with_legacy_s"] = time.perf_counter() - t0
    log(text.rstrip())
    assert len(legacy) == len(rows) == 6
    res["legacy_drift_eval_samples"] = legacy_drift(rows, legacy,
                                                    sweep.SMOKE)
    log("entry_sweep " + json.dumps(res))
    return res


def run_entry_serve(dev, out, arch="stablelm-1.6b", layers=None,
                    requests=ENTRY_REQUESTS):
    """(b) ``python -m repro_torch.benchmarks.serve_bench --arch
    stablelm-1.6b --dtype float32 --fleets 2,4 --slots 2``: both modes'
    tok/s, p50/p95/p99 and occupancy, outputs identical, the swap check.
    In f32: in bf16 the fleet step's batched products and the loop's
    single-node ones round differently, and a greedy output parts where
    two logits nearly tie."""
    import torch

    from repro_torch.benchmarks import serve_bench

    reduced_line(18, "serve_bench", "requests_per_node", 24, requests)
    reduced_line(18, "serve_bench", "repeats", 3, 1)
    reduced_line(18, "serve_bench", "dtype", "bfloat16", "float32")
    argv = (["--fleets", "2,4", "--slots", str(SERVE_SLOTS), "--requests",
             str(requests), "--repeats", "1", "--dtype", "float32",
             "--device", str(dev),
             "--out", str(out)] + (["--arch", arch] if arch else [])
            + (["--layers", str(layers)] if layers else []))
    torch.cuda.reset_peak_memory_stats()
    code, text = captured(serve_bench.main, argv)
    log(text.rstrip())
    with open(out / "BENCH_serve.json") as f:
        rec = json.load(f)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("entry_serve_bench " + json.dumps(rec))
    assert code == 0 and rec["all_checks_passed"], rec
    return rec


def run_entry_model(dev, arch, cfg=None, smoke=False, nodes=None, batch=None,
                    seq=LONG_PREFILL, cut=None, new_tokens=NEW_TOKENS,
                    prompt_len=PROMPT_LEN):
    """(c), (d): ``python -m repro_torch.launch.serve --arch <arch>`` at
    full size (n nodes in one bf16 plane, ``SERVE_SLOTS`` requests a
    node), then one node's (batch, seq) prefill through the flash kernel
    (one launch a layer), its first sequence's last-position logits held
    to the chunked prefill's under ``FLASH_VS_CHUNKED_TOL``."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.transformer import (
        ForwardOptions,
        add_node_axis,
        init_params,
    )
    from repro_torch.serving.serve_step import make_forward_prefill

    spec = ENTRY_MODELS.get(arch, {})
    nodes, batch = nodes or spec["nodes"], batch or spec["batch"]
    cut = cut or spec
    cfg = cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    res = {"arch": cfg.name, "nodes": nodes, "layers": cfg.n_layers,
           "head_dim": cfg.head_dim_, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve.main(["--arch", arch, "--nodes", str(nodes), "--batch",
                       str(SERVE_SLOTS), "--prompt-len", str(prompt_len),
                       "--new-tokens", str(new_tokens), "--device", str(dev)]
                      + (["--smoke"] if smoke else []))
    torch.cuda.synchronize()
    res["cli_s"] = time.perf_counter() - t0
    res["cli_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    assert len(reqs) == nodes * SERVE_SLOTS and all(
        r.done and len(r.output) == new_tokens for r in reqs), reqs
    gc.collect()
    torch.cuda.empty_cache()
    one = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    leaves = tree_util.leaves(one)
    res["params"] = sum(x.numel() for x in leaves)
    res["leaves"] = len(leaves)
    res["plane_gb"] = nodes * sum(x.numel() * x.element_size()
                                  for x in leaves) / 1e9
    del leaves
    assert (res["params"], res["leaves"]) == (cut["params"],
                                              cut["leaves"]), res
    params = add_node_axis(one)
    del one
    toks = torch.randint(0, cfg.vocab_size, (1, batch, seq),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    flash_prefill = make_forward_prefill(cfg, ForwardOptions(
        attn_impl="pallas"))
    flash_prefill(params, {"tokens": toks[:, :1, :256]})   # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = fa.flash_attention.launches
    t0 = time.perf_counter()
    flash = flash_prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    res["flash_prefill_s"] = time.perf_counter() - t0
    res["flash_prefill_tokens_per_s"] = batch * seq / res["flash_prefill_s"]
    res["flash_launches"] = fa.flash_attention.launches - before
    res["prefill_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    assert res["flash_launches"] == cfg.n_layers, res
    assert bool(torch.isfinite(flash).all()) and flash.shape == (
        1, batch, cfg.vocab_size)
    chunked = make_forward_prefill(cfg, ForwardOptions(
        attn_impl="chunked"))(params, {"tokens": toks[:, :1]})
    diff = float((flash[:, 0] - chunked[:, 0]).abs().max())
    res.update({"flash_vs_chunked_max_abs": diff,
                "max_abs_logit": float(flash.abs().max())})
    log("entry_model " + json.dumps(res))
    assert diff <= FLASH_VS_CHUNKED_TOL, (arch, diff)
    del params, flash, chunked, toks
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_entry_train(dev, out, arch=ENTRY_TRAIN["arch"], smoke=False,
                    nodes=ENTRY_TRAIN["nodes"], rounds=ENTRY_TRAIN["rounds"],
                    steps=ENTRY_TRAIN["steps"], seq=ENTRY_TRAIN["seq"],
                    batch=ENTRY_TRAIN["batch"]):
    """(e) ``python -m repro_torch.launch.train``: internvl2-1b at full
    size through its text embedding, n nodes, AdamW, each round's last
    step gossiping through the fused-plane kernel (one ``gossip_plane``
    launch a round); every loss finite, peak memory.  Then the smoke
    config's ``--ckpt-dir``/``--resume`` round trip on the card: 3 rounds
    straight against 2 and a resume, the final params bit for bit (in
    PyTorch's deterministic mode, so no atomic sum reorders)."""
    import math
    import shutil

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.launch import train

    reduced_line(18, "train_driver", "nodes", 8, nodes)
    reduced_line(18, "train_driver", "rounds", 10, rounds)
    reduced_line(18, "train_driver", "steps", 10, steps)
    reduced_line(18, "train_driver", "batch", 8, batch)
    logf = out / "train.jsonl"
    logf.unlink(missing_ok=True)
    argv = ["--arch", arch, "--nodes", str(nodes), "--rounds", str(rounds),
            "--steps", str(steps), "--seq", str(seq), "--batch", str(batch),
            "--device", str(dev), "--log", str(logf)]
    torch.cuda.reset_peak_memory_stats()
    before = gm.gossip_plane.launches
    t0 = time.perf_counter()
    params, text = captured(train.main, argv + (["--smoke"] if smoke else []))
    torch.cuda.synchronize()
    res = {"arch": arch, "nodes": nodes, "rounds": rounds, "steps": steps,
           "seq": seq, "batch": batch, "s": time.perf_counter() - t0,
           "gossip_plane_launches": gm.gossip_plane.launches - before,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(text.rstrip())
    recs = [json.loads(x) for x in logf.read_text().splitlines()]
    res["round_losses"] = [r["loss"] for r in recs]
    res["round_s"] = [r["secs"] for r in recs]
    res["params"] = sum(x[0].numel() for x in tree_util.leaves(params))
    del params
    assert len(recs) == rounds and all(math.isfinite(x)
                                       for x in res["round_losses"]), recs
    assert res["gossip_plane_launches"] == rounds, res
    gc.collect()
    torch.cuda.empty_cache()
    ck = out / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", arch, "--smoke", "--nodes", "4", "--steps", "2",
            "--batch", "2", "--seq", "64", "--device", str(dev)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        whole, _ = captured(train.main, base + ["--rounds", "3"])
        captured(train.main, base + ["--rounds", "2", "--ckpt-dir", str(ck)])
        resumed, text = captured(train.main, base + [
            "--rounds", "3", "--ckpt-dir", str(ck), "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)
    assert "resumed from" in text, text
    res["resume_bit_identical"] = all(
        torch.equal(a, b) for a, b in zip(tree_util.leaves(whole),
                                          tree_util.leaves(resumed)))
    log("entry_train " + json.dumps(res))
    assert res["resume_bit_identical"], res
    return res


def run_entry_phase(dev):
    """Phase 18: the entry points (a)–(e), its own ``ENTRY_BUDGET_S``."""
    import torch

    ENTRY_OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    seconds, res = {}, {}

    def lap(name, fn, *args):
        res[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())
        gc.collect()
        torch.cuda.empty_cache()

    lap("sweep_cli", run_entry_sweep, dev, ENTRY_OUT)
    lap("serve_bench", run_entry_serve, dev, ENTRY_OUT)
    for arch in ENTRY_MODELS:
        lap(arch, run_entry_model, dev, arch)
    lap("train_driver", run_entry_train, dev, ENTRY_OUT)
    log("phase 18 seconds " + json.dumps(seconds))
    return res


# ----------------------------------------------------------------------
# phase 19: the multi-device paths
# ----------------------------------------------------------------------
MULTI_BUDGET_S = 60
MULTI_OUT = Path(__file__).resolve().parent / "chiprun_out" / "multi_device"
# a dense gossip against gossip_plane on the same plane: the same f32
# products, summed in another order (gossip_mix ascending in k, the
# stream kernel in its own order).  Measured on an H100: 1.19e-7 (FFN)
# and 1.79e-7 (VGG-16) max abs, 0.045 and 0.016 of this gate, the
# repo's f32 gate
DENSE_VS_PLANE_REL_TOL = 1e-5


def _saved(counters):
    return [(c.launches, dict(c.shapes)) for c in counters]


def _restore(counters, saved):
    """Yardstick launches (another kernel on the same plane, the kernel
    alone against its plain version) do not count on the main path."""
    for c, (n, shapes) in zip(counters, saved):
        c.launches = n
        c.shapes.clear()
        c.shapes.update(shapes)


def run_gossip_nccl(dev, sizes=(("ffn", FFN_P), ("vgg16", VGG_P))):
    """(a) ``core.gossip`` on a process group of this one process (NCCL on
    the card): ``make_gossip_fn`` at the FFN and VGG-16 planes with BA(33,
    2)'s ``degree`` matrix, each mix exactly one all-gather and one
    ``gossip_mix`` launch, held to ``gossip_plane`` on the same plane by
    ``DENSE_VS_PLANE_REL_TOL``·max|ref|, timed beside it and the byte
    bound; the ``gossip_mix`` launch against its plain version (max abs
    err 0); then ``gossip_sparse`` on ring(33) with ``degree`` weights
    held to ``mix_sparse_host`` (max abs err 0: the same f32 sums)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree as tree_util
    from repro_torch.core import gossip
    from repro_torch.core.decentralized import round_coeffs
    from repro_torch.core.mixing import circulant_decomposition, mix_sparse_host
    from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
    from repro_torch.core.topology import barabasi_albert, ring
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.launch.mesh import init_distributed

    dev = init_distributed(dev)
    res, cases = {"world": dist.get_world_size(),
                  "backend": dist.get_backend()}, []
    gathers = [0]
    orig_gather = gossip._all_gather

    def counted(*args, **kwargs):
        gathers[0] += 1
        return orig_gather(*args, **kwargs)

    gossip._all_gather = counted
    try:
        mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
        c = torch.as_tensor(round_coeffs(barabasi_albert(N_NODES, 2, 0),
                                         AggregationStrategy("degree"), 0),
                            device=dev)   # phase 3's matrix
        fn = gossip.make_gossip_fn(mesh, N_NODES)
        for name, p in sizes:
            params = (ffn_params(dev) if name == "ffn" else vgg_params())
            assert sum(x[0].numel() for x in tree_util.leaves(params)) == p
            before = (gm.gossip_mix.launches, gathers[0])
            out = fn(params, c)
            assert (gm.gossip_mix.launches - before[0],
                    gathers[0] - before[1]) == (1, 1), (name, before)
            yard = _saved((gm.gossip_plane, gm.gossip_mix))
            want = gm.mix_plane(params, c)
            err = max(float((a - b).abs().max()) for a, b in zip(
                tree_util.leaves(out), tree_util.leaves(want)))
            scale = max(float(b.abs().max()) for b in tree_util.leaves(want))
            dense_ms = cuda_ms(lambda: fn(params, c), reps=5)
            plane_ms = cuda_ms(lambda: gm.mix_plane(params, c), reps=5)
            # the launch alone, on the gathered plane, against its plain
            # version and one torch.matmul
            layout, rows = gossip._packed(params)
            blocks = rows.unsqueeze(1)   # as gossip_dense gathers it
            run = lambda: gm.gossip_mix(blocks, c)
            plain = lambda: gm.gossip_mix_ref(blocks, c)
            # the padding columns hold whatever the buffer held
            k_err = float((run() - plain())[..., :p].abs().max())
            ld = rows.shape[1]
            nbytes = 2 * N_NODES * ld * 4 + N_NODES * N_NODES * 4
            flops = 2 * N_NODES * N_NODES * ld
            bnd, by = bound_ms(nbytes, flops)
            case = {
                "name": "gossip_mix", "case": f"gossip_dense_{name}",
                "shape": [N_NODES, 1, ld], "rows": N_NODES,
                "dtype": "float32", "main": False, "max_abs_err": k_err,
                "tolerance": "== 0", "ms": cuda_ms(run),
                "plain_ms": cuda_ms(plain, reps=3),
                "library_ms": cuda_ms(lambda: torch.matmul(c, rows)),
                "library": "torch.matmul", "bound_ms": bnd, "bound_by": by,
                "bytes": nbytes, "flops": flops}
            _restore((gm.gossip_plane, gm.gossip_mix), yard)
            log("kernel_case " + json.dumps(case))
            cases.append(case)
            res[name] = {"dense_vs_plane_max_abs_err": err,
                         "gate": DENSE_VS_PLANE_REL_TOL * scale,
                         "dense_gossip_ms": dense_ms,
                         "mix_plane_ms": plane_ms,
                         "gossip_mix_ms": case["ms"], "bound_ms": bnd}
            log("gossip_dense " + json.dumps({"plane": name, **res[name]}))
            assert err <= DENSE_VS_PLANE_REL_TOL * scale, res[name]
            assert k_err == 0.0, case
            del params, out, want, layout, rows, blocks
            gc.collect()
            torch.cuda.empty_cache() if dev.type == "cuda" else None
        topo = ring(N_NODES)
        sched = circulant_decomposition(mixing_matrix(
            topo, AggregationStrategy("degree")).astype("float32"))
        params = ffn_params(dev)
        sparse = gossip.make_gossip_fn(mesh, N_NODES, schedule=sched)
        got = sparse(params, torch.as_tensor(sched.weights, device=dev))
        want = mix_sparse_host(params, sched)
        s_err = max(float((a - b).abs().max()) for a, b in zip(
            tree_util.leaves(got), tree_util.leaves(want)))
        res["sparse_ring33"] = {
            "offsets": len(sched.offsets), "max_abs_err": s_err,
            "ms": cuda_ms(lambda: sparse(
                params, torch.as_tensor(sched.weights, device=dev)), reps=5),
            "host_ms": cuda_ms(lambda: mix_sparse_host(params, sched),
                               reps=5)}
        log("gossip_sparse " + json.dumps(res["sparse_ring33"]))
        assert s_err == 0.0, res["sparse_ring33"]
    finally:
        gossip._all_gather = orig_gather
        dist.destroy_process_group()
    res["all_gathers"] = gathers[0]
    return res, cases


def _rank_records(root, tag):
    """The ``sweep_rank`` records that the ranks of one ``RANK_RUNS`` entry
    wrote, one file a rank.  Read from files, not from the ranks' shared
    standard output: a rank's line can land inside a line of the other
    rank's block-buffered output there."""
    return [json.loads(p.read_text())
            for p in sorted((root / tag).glob("sweep_rank*.json"))]


def _row_key(rows):
    skip = {"secs", "sweep_secs"}
    return [json.dumps({k: v for k, v in r.items() if k not in skip},
                       sort_keys=True, default=str) for r in rows]


RANK_RUNS = (("sharded", []), ("sharded_chunked", ["--chunk-rounds", "2"]))


def run_sharded_sweep(dev, out, baseline, ranks=2,
                      edges_nodes=ENTRY_EDGES_NODES):
    """(b) ``python -m torch.distributed.run --nproc-per-node 2`` on the
    sweep CLI (:func:`sweep_rank`) with phase 18 (a)'s ``edges`` arguments
    and ``--shard 2`` (two cells: a rank each), both ranks on the one
    card, then in the same ranks with ``--chunk-rounds 2``.  Each rank
    counts its ``gossip_edges`` launches (one a round for its experiment,
    and rank 0's own unsharded comparison at E = 2) and loads the kernels
    phase 1 built.  The rows: equal to ``baseline`` (phase 18 (a)'s) bit
    for bit, or held by ``ENTRY_LEGACY_DRIFT_SAMPLES`` with the gap
    printed; the chunked run's equal to the unchunked one's bit for
    bit."""
    import shutil

    from repro_torch.benchmarks import sweep

    argv = ["--preset", "edges", "--smoke", "--n-nodes", str(edges_nodes),
            "--no-legacy", "--datasets", "mnist", "--seeds", "0",
            "--device", str(dev), "--shard", str(ranks)]
    for tag, _ in RANK_RUNS:
        shutil.rmtree(out / tag, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), str(Path(__file__).resolve()),
           "--sweep-rank", str(out), *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    res = {"wall_s": time.perf_counter() - t0, "launches": 0, "shapes": {}}
    log(proc.stdout.rstrip())
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
    assert proc.returncode == 0, proc.returncode
    rounds = sweep.SMOKE.rounds
    runs = {}
    for tag, _ in RANK_RUNS:
        own = sorted(_rank_records(out, tag), key=lambda d: d["rank"])
        assert [d["rank"] for d in own] == list(range(ranks)), (tag, own)
        assert all(d["tag"] == tag for d in own), (tag, own)
        for d in own:
            sharded = sum(m for k, m in d["shapes"].items()
                          if k.startswith("E=1 "))
            assert sharded == rounds, (tag, d)   # one launch a round
            # rank 0 also runs the grid unsharded (E = 2) to compare
            assert d["launches"] == rounds * (2 if d["rank"] == 0 else 1), d
            assert not d["built"], d
            res["launches"] += d["launches"]
            for k, m in d["shapes"].items():
                res["shapes"][k] = res["shapes"].get(k, 0) + m
        with open(out / tag / "sweep_edges.json") as f:
            runs[tag] = json.load(f)
        with open(out / tag / "BENCH_sweep.json") as f:
            record = json.load(f)["sharded/edges"]
        log(f"sharded/edges ({tag}) " + json.dumps(record))
        res[tag] = {"record": record, "ood_auc": {
            r["strategy"]: r["ood_auc"] for r in runs[tag]}}
    assert _row_key(runs["sharded"]) == _row_key(runs["sharded_chunked"])
    same = _row_key(runs["sharded"]) == _row_key(baseline)
    drift = {k: max(abs(a[k] - b[k]) * sweep.SMOKE.eval_n
                    for a, b in zip(runs["sharded"], baseline))
             for k in ("iid_auc", "ood_auc", "final_ood_acc_mean")}
    res["rows_bit_identical_to_phase18"] = same
    res["drift_eval_samples"] = drift
    log("sharded_sweep " + json.dumps(
        {k: v for k, v in res.items() if k not in ("shapes",)}))
    assert same or max(drift.values()) <= ENTRY_LEGACY_DRIFT_SAMPLES, drift
    return res


def sweep_rank(argv) -> int:
    """One rank of phase 19 (b), under ``torch.distributed.run``: ``argv``
    is the output root, then the sweep CLI's arguments; the CLI runs once
    a ``RANK_RUNS`` entry (its extra arguments, ``--out <root>/<tag>``),
    each followed by a ``sweep_rank`` record with this rank's
    ``gossip_edges`` launches by shape and whether it had to build,
    written to ``<root>/<tag>/sweep_rank<rank>.json`` and logged."""
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    import torch.distributed as dist

    from repro_torch.benchmarks import sweep
    from repro_torch.kernels import build
    from repro_torch.kernels import gossip_mix as gm

    root, cli = Path(argv[0]), list(argv[1:])
    built = not build._library_path("gossip_mix").exists()
    for tag, extra in RANK_RUNS:
        gm.gossip_edges.launches = 0
        gm.gossip_edges.shapes.clear()
        sweep.main(cli + extra + ["--out", str(root / tag)])
        rank = dist.get_rank()
        record = json.dumps({
            "tag": tag, "rank": rank,
            "world": dist.get_world_size(), "built": built,
            "launches": gm.gossip_edges.launches,
            "shapes": {" ".join(map(str, k)): m
                       for k, m in sorted(gm.gossip_edges.shapes.items())}})
        (root / tag).mkdir(parents=True, exist_ok=True)
        (root / tag / f"sweep_rank{rank}.json").write_text(record)
        log("sweep_rank " + record)
    dist.destroy_process_group()
    return 0


def run_multi_phase(dev, baseline=None):
    """Phase 19: (a) gossip on an NCCL group, (b) the sharded sweep CLI
    with two ranks sharing the card; its own ``MULTI_BUDGET_S``.
    ``baseline`` phase 18 (a)'s edges rows (read from its output)."""
    import torch

    MULTI_OUT.mkdir(parents=True, exist_ok=True)
    # NCCL refuses two ranks on one card ("Duplicate GPU detected"), so
    # (a) runs a world of 1
    reduced_line(19, "gossip_nccl", "ranks", 2, 1)
    res = {}
    t0 = time.perf_counter()
    res["gossip"], res["cases"] = run_gossip_nccl(dev)
    res["gossip_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if baseline is None:
        with open(ENTRY_OUT / "sweep_edges.json") as f:
            baseline = json.load(f)
    t0 = time.perf_counter()
    res["sharded_sweep"] = run_sharded_sweep(dev, MULTI_OUT, baseline)
    res["sharded_sweep_s"] = time.perf_counter() - t0
    log("phase 19 seconds " + json.dumps(
        {k: res[k] for k in ("gossip_s", "sharded_sweep_s")}))
    return res


# ----------------------------------------------------------------------
# phase 20: the tooling — the analysis presets on the card, the memory
# dry-run against the card's peaks, the roofline table
# ----------------------------------------------------------------------
TOOLING_BUDGET_S = 45
TOOLING_OUT = Path(__file__).resolve().parent / "chiprun_out" / "tooling"
# the dry-run's prediction of a step's bytes against the card's
# ``max_memory_allocated`` over the same step, each less what was
# allocated before the step's inputs (measured / predicted).  Measured on
# an H100, 700 W (PERF.md §6): 1.000125 (58,022,423,040 B against
# 58,015,145,570) and 1.0000001 (19,332,302,336 against 19,332,300,896)
PEAK_RATIO_BOUNDS = {"internvl2_train_step": (0.999, 1.001),
                     "stablelm_fleet_decode": (0.999, 1.001)}


def dryrun_predictions():
    """The dry-run's predictions for phase 20 (b), host arithmetic on fake
    tensors; run in a process of its own while the card works (it needs
    no device): internvl2-1b's ``make_train_step`` as phase 17 runs it at
    n = 2 and n = 4 (microbatch 1, 2 × 512 tokens a node, AdamW behind the
    nonfinite guard), stablelm-1.6b's fleet decode step as phase 8 times
    it (n = 4, 2 slots, a 4096-position cache), all on one H100."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape, ParallelConfig
    from repro_torch.launch.dryrun import ONE_DEVICE, dry_run_pair

    out = {}
    for n in (TRAIN_NODES, 2 * TRAIN_NODES):
        out[f"internvl2_train_n{n}"] = dry_run_pair(
            "internvl2-1b", InputShape(
                "train_512", TRAIN_SEQ, n * TRAIN_MICRO * TRAIN_LOCAL,
                "train"),
            pcfg=ParallelConfig(n_nodes=n, microbatch=TRAIN_MICRO),
            mesh_shape=ONE_DEVICE, skip_nonfinite=True)
    out["stablelm_fleet_decode"] = dry_run_pair(
        "stablelm-1.6b", InputShape("decode_4096", DECODE_CONTEXT,
                                    SERVE_NODES * SERVE_SLOTS, "decode"),
        pcfg=ParallelConfig(n_nodes=SERVE_NODES), mesh_shape=ONE_DEVICE)
    return out


def run_tooling_presets(dev):
    """(a) ``repro_torch.analysis``'s presets on the card: every report
    clean, every kernel wrapper's ``calls`` equal to its ``launches`` (no
    plain version ran), the rounds under ``set_sync_debug_mode("error")``
    (``analyze`` sets it for the ``HostSync`` rule on a CUDA device)."""
    from repro_torch.analysis.presets import run_preset

    counters = {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{MODULES[name]}"), name) for name in KERNELS}
    for c in counters.values():
        c.calls = 0
    launches0 = {k: c.launches for k, c in counters.items()}
    # the mesh combos run over a sweep mesh of this rank alone
    reduced_line(20, "engine_matrix", "mesh ranks", "all", 1)
    res = {}
    for preset in ("engine-matrix", "serve"):
        t0 = time.perf_counter()
        reports = run_preset(preset, device=dev)
        bad = [str(r) for r in reports if not r.ok]
        res[preset] = {"combos": len(reports), "failing": len(bad),
                       "s": time.perf_counter() - t0}
        log(f"analysis {preset} " + json.dumps(res[preset]))
        for b in bad:
            log(b)
        assert not bad, f"{len(bad)} {preset} report(s) failed"
    calls = {k: c.calls for k, c in counters.items()}
    launched = {k: c.launches - launches0[k] for k, c in counters.items()}
    res["calls"], res["launches"] = calls, launched
    log("analysis calls vs launches " + json.dumps(res))
    assert calls == launched, (calls, launched)
    for name in ("gossip_plane", "gossip_edges", "gossip_robust",
                 "flash_attention"):
        assert calls[name] > 0, (name, calls)
    return res


def run_tooling_phase(dev, predictions, measured):
    """Phase 20: (a) the analysis presets on the card; (b) the dry-run's
    predicted peaks (``predictions``, :func:`dryrun_predictions`) beside
    the card's ``max_memory_allocated`` (``measured``, bytes: phase 17's
    train step, phase 8's long decode step), each ratio within its pinned
    bound, the verdict that internvl2-1b's step at n = 4 does not fit, and
    the 80 GB constant against the card's memory; (c) the roofline table
    (modeled); its own ``TOOLING_BUDGET_S``."""
    import torch

    from repro_torch.benchmarks import roofline

    res = {"presets": run_tooling_presets(dev)}
    total = torch.cuda.get_device_properties(0).total_memory
    res["hbm"] = {"constant_bytes": roofline.HBM_PER_CHIP,
                  "device_total_memory": total,
                  "ratio": total / roofline.HBM_PER_CHIP}
    log("dryrun hbm " + json.dumps(res["hbm"]))
    assert 1.0 <= res["hbm"]["ratio"] <= 1.1, res["hbm"]
    # each step's dry-run, and the kinds of its resident bytes that the
    # card already held when its baseline was taken (phase 8's plane)
    pairs = {"internvl2_train_step": (f"internvl2_train_n{TRAIN_NODES}", ()),
             "stablelm_fleet_decode": ("stablelm_fleet_decode", ("params",))}
    for name, (key, held) in pairs.items():
        pred = predictions[key]["memory"]
        resident = pred["resident_per_device"]
        step_pred = pred["peak_per_device"] - sum(resident[k] for k in held)
        res[name] = {"predicted_peak_bytes": pred["peak_per_device"],
                     "predicted_resident_bytes": resident["total"],
                     "held_before_step": {k: resident[k] for k in held},
                     "predicted_step_bytes": step_pred,
                     "measured_step_bytes": measured[name],
                     "ratio": measured[name] / step_pred,
                     "bound": PEAK_RATIO_BOUNDS[name],
                     "fits_hbm": predictions[key]["fits_hbm"]}
        log(f"dryrun {name} " + json.dumps(res[name]))
    for name in pairs:
        lo, hi = PEAK_RATIO_BOUNDS[name]
        assert lo <= res[name]["ratio"] <= hi, (name, res[name])
    big = predictions[f"internvl2_train_n{2 * TRAIN_NODES}"]
    res["internvl2_n4"] = {"predicted_peak_bytes":
                           big["memory"]["peak_per_device"],
                           "fits_hbm": big["fits_hbm"]}
    log("dryrun internvl2_train_step_n4 " + json.dumps(res["internvl2_n4"]))
    assert not big["fits_hbm"] and res["internvl2_train_step"]["fits_hbm"]
    # the whole table to a file, one compact line to the log
    rows = roofline.full_table()
    TOOLING_OUT.mkdir(parents=True, exist_ok=True)
    with open(TOOLING_OUT / "roofline_1pod.json", "w") as f:
        json.dump(rows, f, indent=1, default=float)
    log("roofline " + json.dumps({
        "modeled": True, "device": "H100 SXM5 datasheet",
        "constants": {"peak_flops": roofline.PEAK_FLOPS,
                      "hbm_bw": roofline.HBM_BW,
                      "link_bw": roofline.ICI_BW,
                      "hbm_bytes": roofline.HBM_PER_CHIP},
        "columns": ["arch", "shape", "t_compute_s", "t_memory_s",
                    "t_collective_s", "dominant", "hbm_gb", "fits"],
        "rows": [[r["arch"], r["shape"], "skip"] if "skipped" in r else
                 [r["arch"], r["shape"]]
                 + [float(f"{r[k]:.4g}") for k in (
                     "t_compute_s", "t_memory_s", "t_collective_s")]
                 + [r["dominant"],
                    round(r["hbm_resident_per_chip"] / 1e9, 2),
                    r["fits_hbm"]] for r in rows]}))
    return res


# ----------------------------------------------------------------------
# phase 21: the examples, the perf-iteration planner, the attention layer
# ----------------------------------------------------------------------
EXAMPLES_BUDGET_S = 60
EXAMPLES_OUT = Path(__file__).resolve().parent / "chiprun_out" / "examples"
LLM_NODES, LLM_ROUNDS = 4, 25        # the LLM example's own defaults
# its --full100m tree: 65,011,712 parameters by param_count() plus the 17
# norm scales (8,704), the gossip plane's width
LLM_PLANE_P = 65_020_416
# the serve step's row of one node (8 nodes in one bmm a weight) against
# decode_step of that node's params alone (one node a bmm): the same f32
# function, products in another order.  Measured on an H100, 700 W
# (PERF.md §6): 1.91e-6 at max|logit| 4.48, 4.3e-7 of it
SERVE_ROW_REL_TOL = 2e-6
ATTN_SMOKE = (("stablelm-1.6b", "global"), ("gemma2-27b", "local"))
ATTN_NODES, ATTN_BATCH, ATTN_SEQ = 2, 2, 256


def run_examples_phase(dev):
    """Phase 21, its own ``EXAMPLES_BUDGET_S``: the port's examples as
    written (``repro_torch.examples``), each part's kernel launches read
    from the counters around it: (a) quickstart (BA(16, 2), 25 rounds,
    einsum: no launch; degree's OOD AUC above unweighted's, as the
    reference script shows on the CPU); (b) the LLM example at
    ``--full100m`` with its defaults (n = 4, 25 rounds of 8 AdamW steps,
    f32): finite losses, the last round's mean below the first's, exactly
    one ``gossip_plane`` launch a round, all at (4, 65,020,416) f32,
    s/round and the peak memory; then ``gossip_plane`` at that shape
    against its plain version (the repo's f32 gate), timed beside its
    bound, ``torch.matmul`` and ``copy_`` (yardstick launches, not counted);
    (c) the two-pod example for both bridges (one inter-pod edge each; the
    hub bridge above the leaf one in global OOD AUC and in the far pod's
    final OOD accuracy, as the reference shows on the CPU; no launch);
    (d) per-node serving (logits (8, 4, 1, 16) finite; the serve step's row
    of the OOD node against ``decode_step`` of that node's params; no
    launch); (e) ``attention_apply`` with and without flash at smoke
    shapes, f32, held by the phase-2 f32 flash gate, one flash launch a
    call; (f) ``perf_iterations`` without ``--verify``: the four modeled
    speedups, no device work."""
    import collections
    import math

    import numpy as np
    import torch

    from repro_torch.benchmarks import perf_iterations
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.decentralized import unstack_params
    from repro_torch.core.plane import aligned_plane
    from repro_torch.core.strategies import AggregationStrategy, mixing_matrix
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.examples import decentralized_llm_pretrain as llm
    from repro_torch.examples import multipod_hierarchy, quickstart
    from repro_torch.examples import serve_per_node
    from repro_torch.kernels import gossip_mix as gm
    from repro_torch.models.layers import attention_apply, attention_init
    from repro_torch.models.transformer import decode_step, init_cache

    counters = {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{MODULES[name]}"), name) for name in KERNELS}
    res, cases = {}, []

    def part(name, fn, *args, **kwargs):
        """One part: its seconds, its launches by kernel and gossip_plane's
        by shape, from the counters just before and just after."""
        before = {k: c.launches for k, c in counters.items()}
        shapes = collections.Counter(gm.gossip_plane.shapes)
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        by_shape = collections.Counter(gm.gossip_plane.shapes) - shapes
        log(f"examples {name}: {secs:.1f} s, launches "
            f"{json.dumps(launched)}")
        return out, secs, launched, by_shape

    # (a) quickstart, as written
    q, secs, launched, _ = part("quickstart", quickstart.run, device=dev)
    runs = q["runs"]
    res["quickstart"] = {"s": secs, "launches": launched, **{
        s: {k: r[k] for k in ("iid_auc", "ood_auc", "final_ood_acc")}
        for s, r in runs.items()}}
    log("examples quickstart " + json.dumps(res["quickstart"]))
    assert not any(launched.values()), launched
    assert runs["degree"]["ood_auc"] > runs["unweighted"]["ood_auc"], runs

    # (b) the LLM example at --full100m with its defaults
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    r, secs, launched, by_shape = part("llm_pretrain", llm.run,
                                       full100m=True, device=dev)
    peak = torch.cuda.max_memory_allocated()
    steps = len(r["step_losses"]) // LLM_ROUNDS
    res["llm_pretrain"] = {
        "s": secs, "nodes": LLM_NODES, "rounds": LLM_ROUNDS, "steps": steps,
        "param_count": r["cfg"].param_count(),
        "s_per_round": r["round_s"],
        "median_s_per_round": statistics.median(r["round_s"]),
        "median_ms_per_step": statistics.median(r["round_s"]) / steps * 1e3,
        "round_losses": r["round_losses"], "launches": launched,
        "gossip_plane_by_shape": {" ".join(map(str, k)): v
                                  for k, v in by_shape.items()},
        "max_memory_allocated": peak, "peak_less_baseline": peak - base}
    log("examples llm_pretrain " + json.dumps(res["llm_pretrain"]))
    assert all(math.isfinite(x) for x in r["step_losses"])
    assert r["round_losses"][-1] < r["round_losses"][0], r["round_losses"]
    assert launched == {k: LLM_ROUNDS if k == "gossip_plane" else 0
                        for k in KERNELS}, launched
    assert dict(by_shape) == {(LLM_NODES, LLM_PLANE_P, "float32"):
                              LLM_ROUNDS}, by_shape
    del r
    gc.collect()
    torch.cuda.empty_cache()
    # the kernel at this shape against its plain version (not counted)
    saved = _saved([gm.gossip_plane])
    c = torch.as_tensor(mixing_matrix(
        barabasi_albert(LLM_NODES, 2, seed=0),
        AggregationStrategy("degree", tau=0.1)), dtype=torch.float32,
        device=dev)
    plane = aligned_plane(LLM_NODES, LLM_PLANE_P, torch.float32, dev)
    plane.copy_(torch.randn((LLM_NODES, LLM_PLANE_P), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(21)))
    run = lambda: gm.gossip_plane(plane, c)
    plain = lambda: gm.gossip_plane_ref(plane, c)
    out, ref = run(), plain()
    max_err = float((out - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    assert bool(torch.isfinite(out).all()) and max_err <= tol, (max_err, tol)
    del out, ref
    nbytes = 2 * LLM_NODES * LLM_PLANE_P * 4 + LLM_NODES * LLM_NODES * 4
    flops = 2 * LLM_NODES * LLM_NODES * LLM_PLANE_P
    bnd, by = bound_ms(nbytes, flops)
    case = {"name": "gossip_plane", "case": "llm_100m_plane",
            "shape": [LLM_NODES, LLM_PLANE_P], "dtype": "float32",
            "main": False, "max_abs_err": max_err,
            "tolerance": f"<= 1e-5*max|ref| = {tol:.3g}",
            "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=5),
            "library_ms": cuda_ms(lambda: torch.matmul(c, plane)),
            "copy_ms": copy_ms(plane), "bound_ms": bnd, "bound_by": by,
            "bytes": nbytes, "flops": flops}
    log("kernel_case " + json.dumps(case))
    cases.append(case)
    _restore([gm.gossip_plane], saved)
    del plane
    torch.cuda.empty_cache()

    # (c) the two-pod example, both bridges
    pods, secs, launched, _ = part("multipod", multipod_hierarchy.run,
                                   device=dev)
    res["multipod"] = {"s": secs, "launches": launched, **{
        b: {k: p[k] for k in ("ood_auc", "far_pod_final_ood_acc",
                              "ood_node", "bridge_edges")}
        for b, p in pods.items()}}
    log("examples multipod " + json.dumps(res["multipod"]))
    assert not any(launched.values()), launched
    assert all(len(p["bridge_edges"]) == 1 for p in pods.values()), pods
    assert pods["hub"]["ood_auc"] > pods["leaf"]["ood_auc"]
    assert pods["hub"]["far_pod_final_ood_acc"] > \
        pods["leaf"]["far_pod_final_ood_acc"]

    # (d) per-node serving
    s, secs, launched, _ = part("serve_per_node", serve_per_node.run,
                                device=dev)
    n = s["logits"].shape[0]
    node = s["ood_node"]
    with torch.no_grad():
        row, _ = decode_step(unstack_params(s["params"], n)[node], s["cfg"],
                             s["prompts"][node],
                             init_cache(s["cfg"], s["prompts"].shape[1], 32,
                                        device=dev))
    ref = s["logits"][node]
    row_err = float((row - ref).abs().max())
    row_tol = SERVE_ROW_REL_TOL * float(ref.abs().max())
    res["serve_per_node"] = {
        "s": secs, "launches": launched,
        "logits_shape": list(s["logits"].shape),
        "probes": {str(k): v.tolist() for k, v in s["probes"].items()},
        "row_vs_decode_step": {"node": node, "max_abs_err": row_err,
                               "max_abs_logit": float(ref.abs().max()),
                               "tolerance": row_tol}}
    log("examples serve_per_node " + json.dumps(res["serve_per_node"]))
    assert not any(launched.values()), launched
    assert tuple(s["logits"].shape) == (8, 4, 1, 16)
    assert bool(torch.isfinite(s["logits"]).all())
    assert row_err <= row_tol, res["serve_per_node"]["row_vs_decode_step"]
    del s, row, ref

    # (e) attention_apply with and without the flash kernel
    gen = torch.Generator(device=dev).manual_seed(5)
    attn = []
    for arch, kind in ATTN_SMOKE:
        cfg = get_smoke_config(arch)
        p = attention_init(gen, cfg, torch.float32, ATTN_NODES)
        x = torch.randn((ATTN_NODES, ATTN_BATCH, ATTN_SEQ, cfg.d_model),
                        generator=gen, device=dev)
        pos = torch.arange(ATTN_SEQ, device=dev)
        flash, _, launched, _ = part(f"attention_apply {arch} {kind}",
                                     attention_apply, p, cfg, x, pos, kind,
                                     True)
        plain = attention_apply(p, cfg, x, pos, kind, False)
        err = float((flash - plain).abs().max())
        tol = FLASH_F32_TOL * float(plain.abs().max())
        attn.append({"arch": arch, "kind": kind,
                     "window": cfg.window_size if kind == "local" else 0,
                     "softcap": cfg.attn_logit_softcap,
                     "shape": [ATTN_NODES, ATTN_BATCH, ATTN_SEQ,
                               cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_],
                     "max_abs_err": err, "tolerance": tol,
                     "launches": launched})
        assert bool(torch.isfinite(flash).all()) and err <= tol, attn[-1]
        assert launched == {k: int(k == "flash_attention")
                            for k in KERNELS}, launched
    res["attention_apply"] = attn
    log("examples attention_apply " + json.dumps(attn))

    # (f) the perf-iteration planner (modeled; no device work)
    EXAMPLES_OUT.mkdir(parents=True, exist_ok=True)
    allocated = torch.cuda.memory_allocated()
    (pi, printed), secs, launched, _ = part(
        "perf_iterations", captured, perf_iterations.main,
        ["--out", str(EXAMPLES_OUT / "perf_iterations.json")])
    res["perf_iterations"] = {
        "modeled": True, "s": secs,
        "speedups": {t: pi[t]["speedup"] for t in "ABCD"},
        "dominant_after": {t: pi[t]["iters"][-1]["dominant"]
                           for t in "ABCD"}}
    log("examples perf_iterations " + json.dumps(res["perf_iterations"]))
    assert printed.startswith("modeled: H100 SXM5 datasheet"), printed[:80]
    assert not any(launched.values()), launched
    assert torch.cuda.memory_allocated() == allocated
    res["cases"] = cases
    return res


# ----------------------------------------------------------------------
# phase 22: the legacy per-round loop
# ----------------------------------------------------------------------
# measured 78.3–79.9 s on an H100 at 700 W (the loop draws and copies
# each round's batches on the host, 0.75–0.90 s a round as the host goes)
LEGACY_BUDGET_S = 120
# (a): the full-scale run_experiment cell (the trainer, one fused-plane
# launch a round) against phase 18 (a)'s fig4 --full degree row (the
# engine, E = 6, the einsum: the mix sums in another order), per node,
# eval samples of 512, max over nodes and eval rounds.  Measured on an
# H100 at 700 W: 1 (OOD AUC 0.95121 against the grid's 0.95120).  Pinned
# at 3, phase 3's bound for backends that sum in other orders
LEGACY_FULL_DRIFT_SAMPLES = 3
# (b): the legacy link-failure loop against the in-scan grid on the same
# cells, both through the fused plane (a batched launch equals E single
# ones): measured 0 samples and equal AUCs in all six cells on an H100,
# as the reference claims; pinned there
LEGACY_LINKFAIL_DRIFT_SAMPLES = 0
# (b) runs two of the ablation's three failure rates: the legacy loop
# draws and copies every round's batches on the host (0.75–0.90 s a round
# at n = 33), and six cells took 45 s
LEGACY_LINKFAIL_P_FAILS = (0.0, 0.3)


def run_legacy_phase(dev, full_reference=None):
    """Phase 22, its own ``LEGACY_BUDGET_S``: the reference's legacy
    per-round loop (Algorithm 1 as a host loop over
    ``DecentralizedTrainer``).  (a) ``run_experiment("mnist",
    barabasi_albert(33, 2, seed=0), "degree", scale=FULL,
    mix_impl="pallas")``: exactly one ``gossip_plane`` launch a round, all
    at (33, 118,282) f32, s/round of the loop, its per-node accuracies
    held to ``full_reference`` (phase 18 (a)'s fig4 ``--full`` degree
    history: the same cell through the engine) by
    ``LEGACY_FULL_DRIFT_SAMPLES``.  (b) ``run_link_failure`` at FULL
    scale cut to ``SWEEP_CUT_ROUNDS`` rounds on BA(33, 2) (unweighted and
    degree at ``LEGACY_LINKFAIL_P_FAILS``, reactive), both through the
    fused plane: the legacy loop (one launch a cell a round) against the
    in-scan grid (one batched launch a round), each row's AUCs equal and
    its per-node drift within ``LEGACY_LINKFAIL_DRIFT_SAMPLES``."""
    from repro_torch.benchmarks import ablations
    from repro_torch.benchmarks.common import FULL, run_experiment
    from repro_torch.core.propagation import accuracy_auc
    from repro_torch.core.topology import barabasi_albert
    from repro_torch.kernels import gossip_mix as gm

    if full_reference is None:
        full_reference = HISTORIES["fig4_full"]["degree"]
    res = {}
    plane_key = (N_NODES, FFN_P, "float32")
    topo = barabasi_albert(N_NODES, 2, seed=0)
    before = gm.gossip_plane.launches
    shapes0 = dict(gm.gossip_plane.shapes)
    t0 = time.perf_counter()
    with SummaryHistories() as sh, TrainerClock() as clock:
        row = run_experiment("mnist", topo, "degree", seed=0, scale=FULL,
                             device=dev, mix_impl="pallas")
    cell_s = time.perf_counter() - t0
    (hist,) = sh.histories
    launches = gm.gossip_plane.launches - before
    at_shape = gm.gossip_plane.shapes.get(plane_key, 0) - shapes0.get(
        plane_key, 0)
    ref_auc = (accuracy_auc(full_reference, "iid"),
               accuracy_auc(full_reference, "ood"))
    full = {"rounds": FULL.rounds, "launches": launches,
            "launches_at_33x118282_f32": at_shape,
            "loop_s": clock.seconds[0],
            "s_per_round": clock.seconds[0] / FULL.rounds,
            "cell_s": cell_s, "iid_auc": row["iid_auc"],
            "ood_auc": row["ood_auc"],
            "final_ood_acc_mean": row["final_ood_acc_mean"],
            "grid_iid_auc": ref_auc[0], "grid_ood_auc": ref_auc[1],
            "drift_eval_samples": held_drift(hist, full_reference)}
    res["full_cell"] = full
    log("legacy_loop full_cell " + json.dumps(full))
    assert launches == at_shape == FULL.rounds, full
    assert full["drift_eval_samples"] <= LEGACY_FULL_DRIFT_SAMPLES + 1e-3, \
        full

    reduced_line(22, "legacy_linkfail", "rounds", FULL.rounds,
                 SWEEP_CUT_ROUNDS)
    reduced_line(22, "legacy_linkfail", "p_fails", [0.0, 0.3, 0.6],
                 list(LEGACY_LINKFAIL_P_FAILS))
    scale = dataclasses.replace(FULL, rounds=SWEEP_CUT_ROUNDS)
    kw = dict(scale=scale, n_nodes=N_NODES, mix_impl="pallas", device=dev,
              p_fails=LEGACY_LINKFAIL_P_FAILS, log=lambda *a: None)
    before = gm.gossip_plane.launches
    with SummaryHistories() as sh, TrainerClock() as clock:
        legacy = ablations.run_link_failure(in_scan=False, **kw)
    legacy_launches = gm.gossip_plane.launches - before
    results = []
    before = gm.gossip_plane.launches
    with EngineClock() as eclock:
        in_scan = ablations.run_link_failure(in_scan=True, results=results,
                                             **kw)
    scan_launches = gm.gossip_plane.launches - before
    (_, result), = results
    cells = []
    for e, (a, b) in enumerate(zip(in_scan, legacy)):
        assert (a["strategy"], a["p_fail"]) == (b["strategy"], b["p_fail"])
        cells.append({
            "strategy": a["strategy"], "p_fail": a["p_fail"],
            "in_scan_auc": (a["iid_auc"], a["ood_auc"]),
            "legacy_auc": (b["iid_auc"], b["ood_auc"]),
            "aucs_equal": (a["iid_auc"], a["ood_auc"]) == (b["iid_auc"],
                                                           b["ood_auc"]),
            "drift_eval_samples": held_drift(result.history(e),
                                             sh.histories[e])})
    link = {"cells": cells, "rounds": scale.rounds,
            "legacy_launches": legacy_launches,
            "in_scan_launches": scan_launches,
            "legacy_s_per_round": [s / scale.rounds for s in clock.seconds],
            "in_scan_s_per_round": eclock.seconds[0] / scale.rounds}
    res["linkfail"] = link
    log("legacy_loop linkfail " + json.dumps(link))
    assert len(legacy) == len(in_scan) == 2 * len(LEGACY_LINKFAIL_P_FAILS)
    assert legacy_launches == len(legacy) * scale.rounds, link
    assert scan_launches == scale.rounds, link
    assert all(c["aucs_equal"] for c in cells), link
    assert max(c["drift_eval_samples"] for c in cells) <= \
        LEGACY_LINKFAIL_DRIFT_SAMPLES + 1e-3, link
    return res


# ----------------------------------------------------------------------
# phase 12: the mix-cost study
# ----------------------------------------------------------------------
STUDY_PARAMS = 8_000_000    # the schedule study's floats a node


def run_mix_study(sc, gm):
    """The port of ``benchmarks/gossip_cost.py`` on the card: every mix
    backend at the FFN and VGG-16 trees (n = 33, BA(33, 2), ``degree``),
    the legacy rows mix making exactly one ``gossip_mix`` launch a leaf;
    the schedule study at 8 M floats a node; the n-scaling study at the
    FFN's width; then the trainer with ``mix_impl="sparse"`` on ring(33),
    where the schedule holds, against the fused plane on the same graph."""
    import numpy as np
    import torch

    from repro_torch.benchmarks import gossip_cost
    from repro_torch.core import decentralized
    from repro_torch.core.topology import ring

    out = {}
    for model, n_leaves, p in (("ffn", FFN_LEAVES, FFN_P),
                               ("vgg16", VGG_LEAVES, VGG_P)):
        rec = gossip_cost.run_mix(log=log, n_nodes=N_NODES, model=model,
                                  reps=5, device="cuda")
        impls = rec["impls"]
        assert rec["config"]["n_leaves"] == n_leaves, rec["config"]
        assert rec["config"]["param_floats_per_node"] == p, rec["config"]
        launches = {k: v["launches_per_mix"] for k, v in impls.items()}
        assert launches == {"einsum": 0, "pallas_rows": n_leaves,
                            "pallas_plane": 1, "pallas_plane_bf16": 1,
                            "edges": 1, "sparse": 0}, launches
        rows_ms = impls["pallas_rows"]["wall_s"] * 1e3
        min_bytes = 2 * N_NODES * p * 4
        legacy = impls["pallas_rows"]["modeled_hbm_bytes"]
        summary = {
            "ms": {k: v["wall_s"] * 1e3 for k, v in impls.items()},
            "launches_per_mix": launches,
            "rows_bound_ms": min_bytes / HBM_BYTES_PER_S * 1e3,
            "rows_legacy_modeled_bytes": legacy,
            "rows_legacy_modeled_ms": legacy / HBM_BYTES_PER_S * 1e3,
            "rows_vs_matmul_einsum": rows_ms / (impls["einsum"]["wall_s"]
                                                * 1e3),
            "sparse_offsets": impls["sparse"]["n_offsets"],
            "sparse_fallback": impls["sparse"]["sparse_fallback"],
        }
        log(f"mix_study {model} " + json.dumps(summary))
        out[model] = summary
        torch.cuda.empty_cache()
    out["schedule"] = gossip_cost.run(log=log, n_params=STUDY_PARAMS,
                                      device="cuda")
    log("schedule_study " + json.dumps(out["schedule"]))
    torch.cuda.empty_cache()
    out["scaling"] = gossip_cost.run_scaling(log=log, n_params=FFN_P,
                                             device="cuda")
    log("scaling_study " + json.dumps(out["scaling"]))
    torch.cuda.empty_cache()

    # the trainer's sparse backend where the schedule holds
    ring_sc = dict(sc, topo=ring(N_NODES))
    support = ring_sc["topo"].adjacency + np.eye(N_NODES)
    assert decentralized.sparse_schedule(support)[0] == (0, 1, N_NODES - 1)
    calls = [0]
    mix_sparse = decentralized.mix_sparse

    def counted(*args, **kw):
        calls[0] += 1
        return mix_sparse(*args, **kw)

    decentralized.mix_sparse = counted
    try:
        for strategy in ("degree", "metropolis"):
            hists = {}
            for impl in ("pallas", "sparse"):
                before = gm.gossip_plane.launches, calls[0]
                tr = ffn_trainer(ring_sc, strategy, impl, 3, 1)
                t0 = time.perf_counter()
                _, hists[impl] = tr.run(ffn_params(),
                                        sc["batcher"].round_batches,
                                        sc["test_iid"], sc["test_ood"])
                secs = time.perf_counter() - t0
                delta = (gm.gossip_plane.launches - before[0],
                         calls[0] - before[1])
                assert delta == {"pallas": (3, 0), "sparse": (0, 3)}[impl], \
                    (strategy, impl, delta)
                for h in hists[impl]:
                    assert np.all(np.isfinite(h.train_loss))
                out[f"ring33_{strategy}_{impl}_s_per_round"] = secs / 3
            drift = max_drift_samples(hists["pallas"], hists["sparse"], 512)
            # phase 3's limit: 3 of 512 eval samples per node
            assert drift <= 3 + 1e-3, (strategy, drift)
            out[f"ring33_{strategy}_drift"] = drift
            log(f"ffn ring(33) {strategy}, 3 rounds, sparse (offsets 0, 1, "
                f"32; no fallback) against pallas: max per-node drift "
                f"{drift:.0f} of 512 eval samples (limit 3)")
    finally:
        decentralized.mix_sparse = mix_sparse
    return out


# ----------------------------------------------------------------------
# phase 5: where one round's time goes
# ----------------------------------------------------------------------
def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def breakdown(name, sc, loss_fn, eval_fn, optimizer, params, reps=2):
    """One round, piece by piece, each ended by a synchronize: host batch
    build + copy to the card, LocalTrain, each kernel mix (pack, launch,
    unpack; the mean through both mean kernels, the trimmed mean through
    the robust kernel), one eval pass (in the trainer's slices of the
    node axis).  ``reps`` rounds, the last kept (the first of two warms
    up)."""
    import numpy as np
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.core.decentralized import (
        make_local_train_fn,
        make_mix_fn,
        node_budget,
        slice_rows,
        vmap_in_slices,
    )

    topo = sc["topo"]
    support = topo.adjacency + np.eye(topo.n_nodes)
    coeffs = trainer_coeffs(sc)
    local = make_local_train_fn(loss_fn, optimizer, sc["batcher"].local_epochs)
    eval_v = torch.func.vmap(eval_fn, in_dims=(0, None))
    to_dev = lambda t: tree_util.tree_map(
        lambda x: torch.as_tensor(x, device="cuda"), t)
    test = to_dev(sc["test_iid"])
    rows = slice_rows(eval_fn, test, topo.n_nodes, node_budget("cuda"))
    opt = optimizer.init(params)
    res = {}
    for rep in range(reps):
        batches, t_host = timed(lambda: to_dev(sc["batcher"].round_batches(rep)))
        (p2, opt2, _), t_local = timed(lambda: local(params, opt, batches))
        steps = tree_util.leaves(batches)[0].shape[1]
        mixes = {}
        for impl, robust in (("pallas", "mean"), ("edges", "mean"),
                             ("edges", "trimmed")):
            mix = make_mix_fn(impl, mix_support=support, robust=robust,
                              device="cuda")
            key = impl if robust == "mean" else robust
            _, mixes[key] = timed(lambda: mix(p2, coeffs))
        with torch.no_grad():
            _, t_eval = timed(lambda: vmap_in_slices(eval_v, p2, test,
                                                     rows))
        res = {"host_batches_s": t_host, "local_train_s": t_local,
               "local_steps": steps, "s_per_local_step": t_local / steps,
               "mix_pallas_s": mixes["pallas"], "mix_edges_s": mixes["edges"],
               "mix_robust_trimmed_s": mixes["trimmed"],
               "eval_one_test_set_s": t_eval, "eval_nodes_a_call": rows}
        del p2, opt2, batches
    log(f"{name}_round_breakdown " + json.dumps(res))
    return res


def trainer_coeffs(sc):
    import torch

    from repro_torch.core.decentralized import round_coeffs
    from repro_torch.core.strategies import AggregationStrategy

    return torch.as_tensor(round_coeffs(sc["topo"],
                                        AggregationStrategy("degree"), 0),
                           device="cuda")


def launches_by_shape(path_shapes, name):
    """One kernel's main-path launches by operand shape, summed over the
    paths."""
    out = {}
    for shapes in path_shapes.values():
        for key, m in shapes.get(name, {}).items():
            out[key] = out.get(key, 0) + m
    return dict(sorted(out.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no repro_torch package under {src}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from repro_torch.kernels import build

    # torch.compile (the flex_attention yardstick) caches beside the kernels
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build.BUILD_DIR / sub))
    from repro_torch.kernels import gossip_mix as gm

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    names = sorted({src[:-3] for src in SOURCES.values()})

    def build_one(name):
        build.build(name)
        return time.perf_counter()

    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        built = [pool.submit(build_one, name) for name in names]
        # the host-only set-up runs while nvcc does
        ffn_sc = ffn_setup()
        vgg_sc = vgg_setup()
        ffn_host = host_batches(ffn_sc, ROUNDS)
        sb_sc = sb_setup()
        sb_host = host_batches(sb_sc, PHASE13_CUT_ROUNDS)
        t_setup = time.perf_counter() - t0
        t_built = max(f.result() for f in built) - t0
    for name in names:
        build.load(name)
    log(f"kernels built from source in {t_built:.1f} s (the host set-up "
        f"alongside, {t_setup:.1f} s); {time.perf_counter() - t0:.1f} s "
        f"since the start")

    # phase 20's dry-run predictions: host arithmetic on fake tensors, in
    # a process of its own while the card works
    dry_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    dry_future = dry_pool.submit(dryrun_predictions)
    t2 = time.perf_counter()
    cases = (check_kernels(dev) + check_flash(dev) + check_rwkv(dev)
             + check_mla(dev) + check_gossip_mix(dev))
    small_device_check()
    log(f"phase 2 (every kernel against its plain version, the small "
        f"device check): {time.perf_counter() - t2:.1f} s")
    counters = {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{MODULES[name]}"), name) for name in KERNELS}
    paths, path_shapes = {}, {}

    def main_path(name, fn, *args):
        """One path of the main path: every count 0 just before, read just
        after."""
        for c in counters.values():
            c.launches = 0
            for k in getattr(c, "kernel_launches", ()):
                c.kernel_launches[k] = 0   # mla_attention's count by kernel
            if hasattr(c, "shapes"):
                c.shapes.clear()
        t = time.perf_counter()
        res = fn(*args)
        paths[name] = {k: c.launches for k, c in counters.items()}
        by_shape = {k: dict(sorted((" ".join(map(str, sh)), m)
                                   for sh, m in c.shapes.items()))
                    for k, c in counters.items() if getattr(c, "shapes", None)}
        path_shapes[name] = by_shape
        gc.collect()
        torch.cuda.empty_cache()
        log(f"main path {name}: {time.perf_counter() - t:.1f} s, launches "
            f"{json.dumps(paths[name])}, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
        log(f"main path {name} launches by shape {json.dumps(by_shape)}")
        return res

    ffn_res = main_path("ffn_mean", run_ffn, ffn_sc, gm, ffn_host)
    torch.cuda.reset_peak_memory_stats()
    main_path("vgg16", run_vgg, vgg_sc, gm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"VGG-16 peak memory {peak_gb:.2f} GB")
    batches = device_batches(ffn_host)
    del ffn_host
    main_path("ffn_robust", run_robust_ffn, ffn_sc, gm, batches,
              ffn_res["degree"])
    main_path("ffn_faults", run_faults, ffn_sc, gm, batches)
    t13 = time.perf_counter()
    main_path("ffn_strategies", run_strategies, ffn_sc, gm, batches, ffn_res)
    main_path("ffn_linkfail", run_linkfail, ffn_sc, gm, batches, ffn_res)
    del batches
    torch.cuda.empty_cache()
    main_path("sb_modularity", run_sb, gm, sb_sc, sb_host)
    del sb_host
    log(f"phase 13 (strategies, link failure, SB graphs): "
        f"{time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    cases += check_batched_kernels(gm)
    main_path("ffn_sweep", run_ffn_sweep, ffn_sc, gm)
    main_path("ffn_sweep_linkfail", run_sweep_linkfail, ffn_sc, gm)
    main_path("ffn_sweep_byzantine", run_sweep_byzantine, ffn_sc, gm)
    log(f"phase 14 (the paper's grids through the sweep engine): "
        f"{time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    cases += check_gpt2_plane(gm)
    gpt2 = main_path("gpt2_tinymem", run_gpt2, gm)
    t15 = time.perf_counter() - t15
    log(f"phase 15 (GPT-2 on TinyMem): {t15:.1f} s (budget {GPT2_BUDGET_S} s)")
    assert t15 <= GPT2_BUDGET_S, f"phase 15 took {t15:.1f} s"
    flash_main = next(c for c in cases
                      if c["name"] == "flash_attention" and c["main"])
    assert flash_main["shape"] == [SERVE_NODES, LONG_PREFILL, 32, 32, 64]
    serving = main_path("serving_stablelm", run_serving, dev,
                        flash_main["ms"])
    main_path("prefill_gemma2", run_gemma2, dev)
    rwkv_main = next(c for c in cases if c["name"] == "rwkv_scan"
                     and c["main"])
    assert rwkv_main["shape"] == [RWKV_NODES, LONG_PREFILL, 40, 64]
    main_path("serving_rwkv6", run_rwkv, dev, rwkv_main["ms"])
    mla_main = next(c for c in cases if c["name"] == "mla_attention"
                    and c["main"])
    assert mla_main["shape"] == [DEEPSEEK_NODES, LONG_PREFILL, 128, 512, 64]
    main_path("serving_deepseek", run_deepseek, dev, mla_main["ms"])
    main_path("mix_study", run_mix_study, ffn_sc, gm)
    t16 = time.perf_counter()
    moe = main_path("serving_moe", run_moe_phase, dev)
    t16 = time.perf_counter() - t16
    log(f"phase 16 (MoE serving): {t16:.1f} s (budget {MOE_BUDGET_S} s), "
        f"peak {moe['peak_memory_gb']:.2f} GB")
    assert t16 <= MOE_BUDGET_S, f"phase 16 took {t16:.1f} s"
    t17 = time.perf_counter()
    zoo = main_path("serving_zoo", run_zoo_phase, dev)
    t17 = time.perf_counter() - t17
    log(f"phase 17 (the rest of the zoo): {t17:.1f} s (budget "
        f"{HYBRID_BUDGET_S} s), peak {zoo['peak_memory_gb']:.2f} GB")
    assert t17 <= HYBRID_BUDGET_S, f"phase 17 took {t17:.1f} s"
    zoo_shapes = path_shapes["serving_zoo"].get("flash_attention", {})
    for key in ("4 4096 25 5 64 bfloat16", "2 4096 14 2 64 bfloat16",
                "2 4096 24 24 64 bfloat16"):
        assert zoo_shapes.get(key, 0) > 0, (key, zoo_shapes)
    t18 = time.perf_counter()
    main_path("entry_points", run_entry_phase, dev)
    t18 = time.perf_counter() - t18
    log(f"phase 18 (the entry points): {t18:.1f} s (budget "
        f"{ENTRY_BUDGET_S} s)")
    assert t18 <= ENTRY_BUDGET_S, f"phase 18 took {t18:.1f} s"
    entry_shapes = path_shapes["entry_points"].get("flash_attention", {})
    for key in ("4 4096 32 32 96 bfloat16", "2 4096 36 4 128 bfloat16"):
        assert entry_shapes.get(key, 0) > 0, (key, entry_shapes)
    for name in ("gossip_plane", "gossip_edges", "flash_attention"):
        assert paths["entry_points"][name] > 0, (name, paths["entry_points"])
    t19 = time.perf_counter()
    multi = main_path("multi_device", run_multi_phase, dev)
    t19 = time.perf_counter() - t19
    log(f"phase 19 (the multi-device paths): {t19:.1f} s (budget "
        f"{MULTI_BUDGET_S} s)")
    assert t19 <= MULTI_BUDGET_S, f"phase 19 took {t19:.1f} s"
    assert paths["multi_device"]["gossip_mix"] > 0, paths["multi_device"]
    cases += multi["cases"]
    # the sharded grid's ranks ran in processes of their own: their
    # counts, as each rank printed them
    ranks = multi["sharded_sweep"]
    paths["multi_device_ranks"] = {k: 0 for k in KERNELS}
    paths["multi_device_ranks"]["gossip_edges"] = ranks["launches"]
    path_shapes["multi_device_ranks"] = {"gossip_edges": ranks["shapes"]}
    log(f"main path multi_device_ranks: launches "
        f"{json.dumps(paths['multi_device_ranks'])}")
    t20 = time.perf_counter()
    predictions = dry_future.result()
    dry_pool.shutdown()
    measured = {"internvl2_train_step": zoo["train_step"]["step_peak_bytes"],
                "stablelm_fleet_decode":
                    serving["fleet_decode_step_long"]["step_peak_bytes"]}
    main_path("tooling", run_tooling_phase, dev, predictions, measured)
    t20 = time.perf_counter() - t20
    log(f"phase 20 (the tooling): {t20:.1f} s (budget {TOOLING_BUDGET_S} s)")
    assert t20 <= TOOLING_BUDGET_S, f"phase 20 took {t20:.1f} s"
    t21 = time.perf_counter()
    examples = main_path("examples", run_examples_phase, dev)
    t21 = time.perf_counter() - t21
    log(f"phase 21 (the examples, the planner, the attention layer): "
        f"{t21:.1f} s (budget {EXAMPLES_BUDGET_S} s)")
    assert t21 <= EXAMPLES_BUDGET_S, f"phase 21 took {t21:.1f} s"
    cases += examples["cases"]
    t22 = time.perf_counter()
    main_path("legacy_loop", run_legacy_phase, dev)
    t22 = time.perf_counter() - t22
    log(f"phase 22 (the legacy per-round loop): {t22:.1f} s (budget "
        f"{LEGACY_BUDGET_S} s)")
    assert t22 <= LEGACY_BUDGET_S, f"phase 22 took {t22:.1f} s"
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    log(f"main path launches {json.dumps(launches)}")
    assert all(v > 0 for v in launches.values()), launches

    from repro_torch.models.paper_models import (
        classifier_accuracy,
        classifier_loss,
        ffn_apply,
        vgg_apply,
    )
    from repro_torch.training.optimizer import adam, sgd

    breakdown("ffn", ffn_sc, classifier_loss(ffn_apply),
              classifier_accuracy(ffn_apply), sgd(1e-2), ffn_params())
    breakdown("vgg16", vgg_sc, classifier_loss(vgg_apply),
              classifier_accuracy(vgg_apply), adam(1e-4), vgg_params())
    from repro_torch.core.decentralized import stack_params

    _, lm_loss_fn, lm_acc_fn, lm_opt = gpt2_fns()
    breakdown("gpt2_tinymem", gpt2["sc"], lm_loss_fn, lm_acc_fn, lm_opt,
              stack_params([gpt2_init()] * N_NODES), reps=1)

    kernels = []
    for name in KERNELS:
        own = [c for c in cases if c["name"] == name]
        main_case = next(c for c in own if c["main"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[name],
            **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "shape": main_case["shape"], "dtype": main_case["dtype"],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "launches_by_shape": launches_by_shape(path_shapes, name),
            "cases": own,
        })
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the start of "
        f"the build to the end")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sweep-rank"]:   # one rank of phase 19 (b)
        sys.exit(sweep_rank(sys.argv[2:]))
    sys.exit(main())
