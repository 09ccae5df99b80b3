"""Presets: ``engine-matrix`` (one report per engine program) and
``serve`` (the fleet serving tier's steps) — port of
``repro/analysis/presets.py``.

The sweep engine is one program family: (mode: scanned / chunked / mesh /
unrolled) × (mix_impl: einsum / pallas / sparse / edges) × (coefficient
kind: materialized stack / in-loop program), plus the low-precision-plane
ablations (bf16 params × ``mix_in_float32``) and the participation, fault
and robust cells: the reference's 49 combos.  Each runs through
:meth:`SweepEngine.traceable` — the exact step :meth:`SweepEngine.run`
executes — on the reference's tiny but structurally complete setting
(ring(8), a 2-experiment grid, 12 rounds, the paper's FFN), and the whole
rule catalog checks it.  The mesh combos run over a sweep mesh of one
rank (a world of this process alone when no process group exists).

Fusion budgets are derived: the einsum counts a (mode, kind) are pinned in
:data:`EINSUM_BASELINE` (regenerate with ``python -m repro_torch.analysis
--recalibrate`` after an intended change of the round), and every other
combo's expectation is ``baseline − einsum mix budget + its impl's mix
budget`` (``core.decentralized.mix_impl_budget``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.analysis.report import Report
from repro_torch.analysis.rules import (
    AnalysisContext,
    ConstantFootprint,
    Donation,
    DtypeFlow,
    FusionBudget,
    HostSync,
    Rule,
    analyze,
)

__all__ = [
    "Combo",
    "ServeCombo",
    "engine_matrix_combos",
    "serve_combos",
    "rules_for",
    "serve_rules",
    "expected_budget",
    "run_combo",
    "run_preset",
    "recalibrate",
    "PRESETS",
    "EINSUM_BASELINE",
]

# ----------------------------------------------------------------------
# the analyzed setting: the reference's
# ----------------------------------------------------------------------
N_NODES = 8      # ring(8): circulant, so the sparse schedule covers it
N_EXP = 2        # two strategies through one grid
ROUNDS = 12      # an (R, n, n) f32 stack is 3 KiB: it must not be uploaded
BATCH = 4
EVAL_EVERY = 4
CHUNK_ROUNDS = 4

MODES: Tuple[str, ...] = ("scanned", "chunked", "mesh", "unrolled")
IMPLS: Tuple[str, ...] = ("einsum", "pallas", "sparse", "edges")
KINDS: Tuple[str, ...] = ("stack", "program")

#: Upload caps, sized as the reference sizes its constant caps: the leak
#: this guards (an (R, n, n) stack uploaded inside a round) is
#: ROUNDS·N_NODES² f32 = 3072 B a experiment, above the per-upload cap;
#: what a round legitimately uploads (a program's (E, n, n) matrices,
#: 512 B; participation and fault masks, (E, n) each) stays well under.
MAX_UPLOAD_BYTES = 2048
MAX_TOTAL_UPLOAD_BYTES = 8192


@dataclasses.dataclass(frozen=True)
class Combo:
    """One cell of the engine matrix (the reference's fields)."""

    mode: str
    impl: str
    kind: str
    param_dtype: str = "float32"
    mix_in_float32: bool = True
    participation: bool = False
    fault: bool = False
    robust: str = "mean"

    @property
    def name(self) -> str:
        tag = f"{self.mode}/{self.impl}/{self.kind}"
        if self.param_dtype != "float32":
            tag += (f"/{self.param_dtype}-"
                    + ("accum32" if self.mix_in_float32 else "accumlow"))
        if self.participation:
            tag += "/part"
        if self.fault:
            tag += "/fault"
        if self.robust != "mean":
            tag += f"/{self.robust}"
        return tag


def engine_matrix_combos() -> List[Combo]:
    """32 mode × impl × kind cells + 4 low-precision-plane ablations + 5
    partial-participation cells + 8 fault/robust cells: 49."""
    combos = [Combo(m, i, k) for m in MODES for i in IMPLS for k in KINDS]
    combos += [
        Combo("scanned", impl, "stack", "bfloat16", m32)
        for impl in ("pallas", "edges")
        for m32 in (True, False)
    ]
    combos += [Combo(m, "einsum", "stack", participation=True)
               for m in MODES]
    combos += [Combo("scanned", "pallas", "stack", participation=True)]
    combos += [Combo(m, "einsum", "stack", fault=True) for m in MODES]
    combos += [
        Combo("scanned", "einsum", "stack", robust="trimmed"),
        Combo("scanned", "einsum", "stack", robust="norm_clip"),
        Combo("scanned", "edges", "stack", robust="median"),
        Combo("scanned", "einsum", "stack", fault=True, robust="trimmed"),
    ]
    return combos


@functools.lru_cache(maxsize=None)
def _host_setting():
    """The engine's host inputs (numpy), built once."""
    from repro_torch.core.coeffs import program_for, stack_states
    from repro_torch.core.strategies import AggregationStrategy
    from repro_torch.core.topology import ring
    from repro_torch.data.distribution import node_datasets
    from repro_torch.data.pipeline import NodeBatcher, make_test_batch
    from repro_torch.data.synthetic import make_dataset

    topo = ring(N_NODES)
    train = make_dataset("mnist", 320, seed=0)
    test = make_dataset("mnist", 64, seed=9)
    parts = node_datasets(train, N_NODES, ood_node=0, q=0.10, seed=0)
    nb = NodeBatcher(parts, batch_size=BATCH, steps_per_epoch=1, seed=0)
    tb = make_test_batch(test, 16, seed=0)
    ob = make_test_batch(test, 16, seed=1)
    cells = [("unweighted", 0), ("degree", 1)]
    progstates = [
        program_for(topo, AggregationStrategy(k, tau=0.1, seed=s),
                    data_counts=nb.data_counts())
        for k, s in cells]
    st = lambda t: {k: np.stack([np.asarray(t[k])] * N_EXP) for k in t}
    return {
        "support": topo.adjacency + np.eye(N_NODES),   # neighbours ∪ self
        "seeds": [s for _, s in cells],
        "program": progstates[0][0],
        "states": stack_states([s for _, s in progstates]),
        "stacks": np.stack([p.materialize(s, ROUNDS)
                            for p, s in progstates]),
        "bank": {k: v[None] for k, v in nb.sample_bank().items()},
        "indices": nb.all_round_indices(ROUNDS)[None],
        "data_idx": np.zeros(N_EXP, np.int64),
        "test_iid": st(tb),
        "test_ood": st(ob),
    }


def _params0(dtype: str):
    """``(E, n, ...)`` FFN inits, one seed a cell (on the CPU; the engine
    places them)."""
    from repro_torch.core.decentralized import stack_params
    from repro_torch.models.paper_models import ffn_init

    cells = [stack_params([ffn_init(torch.Generator().manual_seed(s))]
                          * N_NODES) for s in _host_setting()["seeds"]]
    return tree_util.tree_map(
        lambda *xs: torch.stack(xs).to(getattr(torch, dtype)), *cells)


@functools.lru_cache(maxsize=None)
def _engine(impl: str, mix_in_float32: bool, robust: str, device: str):
    from repro_torch.core.decentralized import DecentralizedConfig
    from repro_torch.core.sweep import SweepEngine
    from repro_torch.models.paper_models import (
        classifier_accuracy,
        classifier_loss,
        ffn_apply,
    )
    from repro_torch.training.optimizer import sgd

    cfg = DecentralizedConfig(
        rounds=ROUNDS, local_epochs=1, eval_every=EVAL_EVERY,
        mix_impl=impl, mix_in_float32=mix_in_float32, epoch_shuffle=False,
        robust=robust)
    return SweepEngine(sgd(1e-2), classifier_loss(ffn_apply),
                       classifier_accuracy(ffn_apply), cfg,
                       mix_support=_host_setting()["support"],
                       device=device)


@contextlib.contextmanager
def one_rank_mesh():
    """A sweep mesh of this rank alone, over the caller's process group
    or, where there is none, a world of this process alone (gloo), torn
    down on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_sweep_mesh

    own = not dist.is_initialized()
    if own:
        init_distributed("cpu")
    try:
        yield make_sweep_mesh(1)
    finally:
        if own:
            dist.destroy_process_group()


def _traceable(combo: Combo, device, mesh=None):
    """``(fn, args, kwargs)`` for one combo: the engine's own
    :meth:`SweepEngine.traceable` on the shared setting."""
    from repro_torch.core.coeffs import ProgramCoeffs
    from repro_torch.core.dynamic import FaultSpec, ParticipationSpec

    s = _host_setting()
    engine = _engine(combo.impl, combo.mix_in_float32, combo.robust,
                     str(device))
    coeffs = (s["stacks"] if combo.kind == "stack"
              else ProgramCoeffs(s["program"], s["states"]))
    extra = {}
    if combo.participation:
        extra.update(participation=ParticipationSpec(),
                     participation_rates=np.asarray([1.0, 0.5], np.float32))
    if combo.fault:
        # quarantine=True threads the whole screen (norm EMA, probation
        # timers) through the round
        extra.update(fault=FaultSpec(quarantine=True),
                     fault_rates=np.asarray([0.0, 0.3], np.float32))
    return engine.traceable(
        _params0(combo.param_dtype), coeffs, s["bank"], s["indices"],
        s["data_idx"], s["test_iid"], s["test_ood"], batch_size=BATCH,
        mode=combo.mode, mesh=mesh, chunk_rounds=CHUNK_ROUNDS,
        donate=combo.mode in ("chunked", "mesh"), **extra)


# ----------------------------------------------------------------------
# fusion-budget calibration
# ----------------------------------------------------------------------
#: Pinned einsum-mode counts a (mode, kind) in the first round, on the
#: setting above (``python -m repro_torch.analysis --recalibrate``): 20 =
#: LocalTrain's 8 products (the FFN's forward 3 and backward 5, one local
#: step, the grid folded into one call) + the einsum mix's 12 (6 leaves ×
#: 2 experiments, one product each).  The unrolled step's round also
#: evaluates (IID and OOD forwards, 3 each: 26); the other modes' first
#: round does not (eval every 4th).
EINSUM_BASELINE: Dict[Tuple[str, str], Dict[str, int]] = {
    ("scanned", "stack"): {"kernel_call": 0, "matmul": 20},
    ("scanned", "program"): {"kernel_call": 0, "matmul": 20},
    ("chunked", "stack"): {"kernel_call": 0, "matmul": 20},
    ("chunked", "program"): {"kernel_call": 0, "matmul": 20},
    ("mesh", "stack"): {"kernel_call": 0, "matmul": 20},
    ("mesh", "program"): {"kernel_call": 0, "matmul": 20},
    ("unrolled", "stack"): {"kernel_call": 0, "matmul": 26},
    ("unrolled", "program"): {"kernel_call": 0, "matmul": 26},
}


def _n_leaves() -> int:
    return len(tree_util.leaves(_params0("float32")))


def expected_budget(combo: Combo) -> Dict[str, int]:
    """``baseline − einsum mix budget + combo impl's mix budget``."""
    from repro_torch.core.decentralized import mix_impl_budget

    base = EINSUM_BASELINE[(combo.mode, combo.kind)]
    ein = mix_impl_budget("einsum", _n_leaves(), experiments=N_EXP)
    imp = mix_impl_budget(combo.impl, _n_leaves(),
                          mix_support=_host_setting()["support"],
                          robust=combo.robust, experiments=N_EXP)
    return {k: base[k] - ein[k] + imp[k] for k in ("kernel_call", "matmul")}


def rules_for(combo: Combo) -> List[Rule]:
    """The whole catalog, parameterized for one combo."""
    from repro_torch.kernels.gossip_mix import mix_accum_upcasts

    upcasts = mix_accum_upcasts(
        combo.impl, combo.mix_in_float32,
        plane_low_precision=combo.param_dtype != "float32")
    return [
        FusionBudget.of(expected_budget(combo), scope="round"),
        ConstantFootprint(max_total_bytes=MAX_TOTAL_UPLOAD_BYTES,
                          max_upload_bytes=MAX_UPLOAD_BYTES),
        DtypeFlow(expect_kernel_upcasts=upcasts),
        Donation(expect=combo.mode in ("chunked", "mesh")),
        HostSync(scope="round"),
    ]


# ----------------------------------------------------------------------
# the ``serve`` preset
# ----------------------------------------------------------------------
SERVE_N_NODES = 2   # the fleet axis over the parameter plane
SERVE_SLOTS = 2     # decode slots a node
SERVE_CHUNK = 8     # the mixed prefill chunk; a decode step takes 1
SERVE_MAX_SEQ = 32


@dataclasses.dataclass(frozen=True)
class ServeCombo:
    """One serving-tier step: ``"fleet-prefill"`` (the full-sequence flash
    prefill over the plane's fleet, one flash call a layer),
    ``"fleet-decode"`` (the one-token fleet step),
    ``"fleet-chunked-prefill"`` (the scheduler's mixed self-feeding chunk,
    the reference's fleet prefill) and ``"node-prefill"`` (one node's
    chunk, the per-node loop's hot path)."""

    program: str

    @property
    def name(self) -> str:
        return f"serve/{self.program}"


def serve_combos() -> List[ServeCombo]:
    return [ServeCombo(p) for p in ("fleet-prefill", "fleet-decode",
                                    "fleet-chunked-prefill",
                                    "node-prefill")]


def _serve_config():
    """A tiny f32 fleet (head dim 32, so the card's flash kernels take
    it)."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="serve-lint", n_layers=2, d_model=128, n_heads=4,
                       n_kv_heads=2, d_ff=256, vocab_size=64,
                       dtype="float32", param_dtype="float32")


def _serve_traceable(combo: ServeCombo, device):
    from repro_torch.core.plane import PlaneLayout
    from repro_torch.models.transformer import ForwardOptions, init_params
    from repro_torch.serving.serve_step import (
        make_cache,
        make_fleet_decode_step,
        make_fleet_prefill_step,
        make_forward_prefill,
        make_prefill_step,
    )

    cfg = _serve_config()
    dev = torch.device(device)
    stacked = tree_util.tree_map(
        lambda *xs: torch.stack(xs),
        *[init_params(torch.Generator(device=dev).manual_seed(i), cfg)
          for i in range(SERVE_N_NODES)])
    layout = PlaneLayout.from_tree(stacked)
    plane = layout.pack(stacked)
    cache = make_cache(cfg, SERVE_N_NODES, SERVE_SLOTS, SERVE_MAX_SEQ, dev)
    n, b = SERVE_N_NODES, SERVE_SLOTS
    chunk = 1 if combo.program == "fleet-decode" else SERVE_CHUNK
    toks = torch.ones((n, b, chunk), dtype=torch.int32, device=dev)
    feed = torch.ones((n, b), dtype=torch.int32, device=dev)
    lens = torch.full((n, b), chunk, dtype=torch.int32, device=dev)
    if combo.program == "fleet-prefill":
        step = make_forward_prefill(cfg, ForwardOptions(attn_impl="pallas"))
        return (lambda p, t: step(layout.unpack(p), {"tokens": t}),
                (plane, toks), {})
    if combo.program == "fleet-decode":
        return make_fleet_decode_step(cfg, layout), (plane, toks, cache), {}
    if combo.program == "fleet-chunked-prefill":
        return (make_fleet_prefill_step(cfg, layout),
                (plane, toks, feed, lens, cache), {})
    one = tree_util.tree_map(lambda x: x[0], stacked)
    one_cache = tree_util.tree_map(lambda x: x[0], cache)
    return (make_prefill_step(cfg),
            (one, toks[0], feed[0], lens[0], one_cache), {})


def serve_rules(combo: ServeCombo) -> List[Rule]:
    """No host round-trip anywhere in a step (one dispatch advances every
    node's slots) and no f64; the fleet prefill makes exactly one flash
    call a layer for the whole fleet."""
    rules: List[Rule] = [HostSync(scope="all"),
                         DtypeFlow(expect_kernel_upcasts=None)]
    if combo.program == "fleet-prefill":
        rules.insert(0, FusionBudget.of(
            {"flash_attention": _serve_config().n_layers}, scope="all"))
    return rules


def run_combo(combo, device=None, mesh=None) -> Report:
    """One combo's report on ``device`` (None: the card); a mesh combo
    needs ``mesh`` (:func:`one_rank_mesh`)."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    if isinstance(combo, ServeCombo):
        fn, args, kwargs = _serve_traceable(combo, dev)
        rules = serve_rules(combo)
    else:
        fn, args, kwargs = _traceable(combo, dev, mesh)
        rules = rules_for(combo)
    return analyze(fn, *args, rules=rules, name=combo.name, device=dev,
                   **kwargs)


def run_preset(preset: str = "engine-matrix", only: Optional[str] = None,
               device=None) -> List[Report]:
    combos = PRESETS[preset]()
    if only is not None:
        pat = re.compile(only)
        combos = [c for c in combos if pat.search(c.name)]
    meshed = any(getattr(c, "mode", None) == "mesh" for c in combos)
    with (one_rank_mesh() if meshed else contextlib.nullcontext()) as mesh:
        return [run_combo(c, device, mesh) for c in combos]


def recalibrate(device=None) -> Dict[Tuple[str, str], Dict[str, int]]:
    """The einsum baselines measured on the current engine: the literal to
    paste into :data:`EINSUM_BASELINE` after an intended change."""
    from repro_torch import resolve_device
    from repro_torch.analysis.walker import OpRecorder

    dev = resolve_device(device)
    out: Dict[Tuple[str, str], Dict[str, int]] = {}
    with one_rank_mesh() as mesh:
        for mode in MODES:
            for kind in KINDS:
                fn, args, kwargs = _traceable(Combo(mode, "einsum", kind),
                                              dev, mesh)
                with OpRecorder() as rec:
                    fn(*args, **kwargs)
                rule = FusionBudget.of({"kernel_call": 0, "matmul": 0})
                out[(mode, kind)] = rule.measure(
                    AnalysisContext(events=rec.events))
    return out


PRESETS = {
    "engine-matrix": engine_matrix_combos,
    "serve": serve_combos,
}
