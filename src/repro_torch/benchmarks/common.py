"""Shared harness of the paper-figure drivers (port of
``benchmarks/common.py``).

Two paths over the same grid:

* :func:`run_experiment` — the legacy path: ONE cell (dataset, topology,
  strategy, OOD placement) a call, Algorithm 1 as a host loop over
  ``DecentralizedTrainer`` (a round's batches copied to the device, its
  mix, an evaluation every ``eval_every`` rounds); the wall-clock
  baseline the sweep engine is compared against.
* :func:`run_sweep_cells` — the batched path.  A figure is a grid of
  declarative :class:`SweepCell` objects, grouped by program shape
  (:func:`group_cells`: dataset, node count, robust rule); each group runs
  as ONE ``core.sweep.SweepEngine`` program, the experiments on its batch
  axis: cells that share a data configuration (seed × OOD placement)
  share a row of the sample bank, each cell's coefficients come from its
  coefficient program (materialized to a stack, or generated round by
  round with ``coeff_mode="program"``), and each row gets the host
  summary (``propagation_summary``), the streaming analytics digest with
  its deviation from the host oracle (``stream_vs_host_max_dev``), and
  the participation and fault digests.

Scales: :data:`QUICK` and :data:`FULL` (the paper's n = 33, R = 40,
E_local = 5).  Models: the three rows of Table 1 — the FFN (MNIST,
FMNIST), VGG-16 (CIFAR-10/100) and GPT-2 cut to one layer (TinyMem).
Everything runs on the card unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks.gossip_cost import csv_row
from repro_torch.core.analytics import (
    AnalyticsSpec,
    analytics_summary,
    participation_summary,
    quarantine_summary,
)
from repro_torch.core.coeffs import (
    PROGRAM_KINDS,
    ProgramCoeffs,
    program_for,
    stack_states,
)
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    DecentralizedTrainer,
    coeffs_stack,
    stack_params,
)
from repro_torch.core.dynamic import FaultSpec, ParticipationSpec
from repro_torch.core.propagation import per_node_auc, propagation_summary
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.topology import Topology, barabasi_albert, ring
from repro_torch.data.backdoor import backdoored_testset
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher, make_test_batch
from repro_torch.data.synthetic import make_dataset
from repro_torch.models.paper_models import (
    classifier_accuracy,
    classifier_loss,
    ffn_apply,
    ffn_init,
    gpt2_tinymem_config,
    lm_accuracy,
    lm_loss,
    vgg_apply,
    vgg_init,
)
from repro_torch.models.transformer import init_params as tf_init
from repro_torch.training.optimizer import adam, sgd, skip_nonfinite_updates

__all__ = ["DATASET_SETUP", "BenchScale", "QUICK", "FULL",
           "DEFAULT_ARRIVAL_THRESHOLD", "SweepCell", "linkfail_cells",
           "multisource_cells", "edges_cells", "participation_cells",
           "byzantine_cells", "group_cells", "run_sweep_cells", "csv_row",
           "cell_data", "run_experiment"]

# Table 1 of the paper: model and optimizer per dataset (VGG at a quarter
# of its width, as the reference's drivers run it)
DATASET_SETUP = {
    "mnist": dict(model="ffn", opt=("sgd", 1e-2)),
    "fmnist": dict(model="ffn", opt=("sgd", 1e-2)),
    "cifar10": dict(model="vgg", opt=("adam", 1e-4)),
    "cifar100": dict(model="vgg", opt=("adam", 1e-4)),
    "tinymem": dict(model="gpt2", opt=("adam", 1e-3)),
}


@dataclasses.dataclass
class BenchScale:
    n_train: int = 6000
    n_test: int = 600
    rounds: int = 15
    local_epochs: int = 3
    batch: int = 32
    steps_per_epoch: int = 8
    eval_every: int = 3
    eval_n: int = 256


# QUICK: the paper's R ≈ 40 / E = 5 regime at 30 rounds (below ~20 rounds
# the topology trends invert: dilution-limited, not propagation-limited)
QUICK = BenchScale(rounds=30, local_epochs=5, eval_every=5)
FULL = BenchScale(n_train=20000, n_test=2000, rounds=40, local_epochs=5,
                  batch=32, steps_per_epoch=0, eval_every=4, eval_n=512)
#: accuracy that counts as "OOD knowledge arrived" for the analytics
DEFAULT_ARRIVAL_THRESHOLD = 0.5


def _model_fns(dataset: str):
    """``(init(seed) -> one node's params, loss, accuracy, optimizer)``."""
    setup = DATASET_SETUP[dataset]
    kind, (opt_name, lr) = setup["model"], setup["opt"]
    opt = sgd(lr) if opt_name == "sgd" else adam(lr)
    gen = lambda seed: torch.Generator().manual_seed(int(seed))
    if kind == "ffn":
        return (lambda seed: ffn_init(gen(seed), in_dim=28 * 28),
                classifier_loss(ffn_apply), classifier_accuracy(ffn_apply),
                opt)
    if kind == "vgg":
        n_classes = 100 if dataset == "cifar100" else 10
        return (lambda seed: vgg_init(gen(seed), n_classes=n_classes,
                                      width_mult=0.25),
                classifier_loss(vgg_apply), classifier_accuracy(vgg_apply),
                opt)
    cfg = gpt2_tinymem_config()
    return (lambda seed: tf_init(gen(seed), cfg), lm_loss(cfg),
            lm_accuracy(cfg), opt)


@functools.lru_cache(maxsize=32)
def _data(dataset: str, n_train: int, n_test: int, seed: int):
    train = make_dataset(dataset, n_train, seed=seed)
    test = make_dataset(dataset, n_test, seed=seed + 9999)
    return train, test


def run_experiment(dataset: str, topo: Topology, strategy: str,
                   ood_k: int = 1, tau: float = 0.1, seed: int = 0,
                   scale: BenchScale = QUICK, alpha_l: float = 1000.0,
                   alpha_s: float = 1000.0,
                   ood_ks: Optional[Tuple[int, ...]] = None, *,
                   device=None, mix_impl: str = "einsum") -> Dict:
    """One cell through the per-round loop → its summary row.

    ``ood_k`` puts the OOD data on the k-th highest-degree node;
    ``ood_ks`` overrides it with several degree ranks at once (the
    placement of ``SweepCell.ood_ks``, so the loop stays a baseline for
    multi-source grids).  ``alpha_l``/``alpha_s`` are the label and size
    Dirichlet skews of the split (paper B.2.1).  ``device`` (None: the
    card, raising without one) and ``mix_impl`` (the trainer's backend:
    ``"pallas"`` one fused-plane launch a round, ``"edges"`` the edge-list
    kernel) are the port's."""
    t0 = time.time()
    ood_nodes = tuple(topo.kth_highest_degree_node(k)
                      for k in (ood_ks or (ood_k,)))
    nb, tb, ob = cell_data(dataset, topo.n_nodes, seed, ood_nodes, scale,
                           scale.steps_per_epoch, alpha_l, alpha_s)
    init, loss_fn, acc_fn, opt = _model_fns(dataset)
    params = stack_params([init(seed)] * topo.n_nodes)
    trainer = DecentralizedTrainer(
        topo, AggregationStrategy(strategy, tau=tau, seed=seed), opt,
        loss_fn, acc_fn,
        DecentralizedConfig(rounds=scale.rounds,
                            local_epochs=scale.local_epochs,
                            eval_every=scale.eval_every, unroll_eval=True,
                            mix_impl=mix_impl),
        data_counts=nb.data_counts(), device=device)
    _, hist = trainer.run(params, nb.round_batches, tb, ob)
    summary = propagation_summary(hist, topo.adjacency, ood_nodes)
    summary.update(
        dataset=dataset, topology=topo.name, strategy=strategy, ood_k=ood_k,
        ood_node=(ood_nodes[0] if len(ood_nodes) == 1 else list(ood_nodes)),
        seed=seed, secs=round(time.time() - t0, 1))
    if ood_ks:
        summary["ood_ks"] = list(ood_ks)
    return summary


def cell_data(dataset: str, n_nodes: int, seed: int,
              ood_nodes: Tuple[int, ...], scale: BenchScale,
              steps_per_epoch: int, alpha_l: float = 1000.0,
              alpha_s: float = 1000.0):
    """``(batcher, test_iid, test_ood)`` of one data configuration, as the
    reference builds it: the node split with the OOD data on
    ``ood_nodes``, IID and backdoored test batches of ``scale.eval_n``."""
    train, test = _data(dataset, scale.n_train, scale.n_test, seed)
    parts = node_datasets(train, n_nodes, ood_node=ood_nodes, q=0.10,
                          seed=seed, alpha_l=alpha_l, alpha_s=alpha_s)
    nb = NodeBatcher(parts, batch_size=scale.batch,
                     steps_per_epoch=steps_per_epoch, seed=seed,
                     local_epochs=scale.local_epochs)
    return (nb, make_test_batch(test, scale.eval_n, seed=seed),
            make_test_batch(backdoored_testset(test, seed=seed),
                            scale.eval_n, seed=seed,
                            ood_mask=(test.kind == "lm")))


@dataclasses.dataclass(frozen=True, eq=False)
class SweepCell:
    """One cell of a figure's grid, as data.

    ``name`` is the CSV label; ``sweep`` a free-form annotation the
    verdicts group by.  ``p_fail`` drops each edge i.i.d. a round and
    ``reactive`` recomputes centralities on the survivor (the cell's
    coefficient program).  ``ood_ks`` places OOD data on several degree
    ranks at once (overriding ``ood_k``).  ``participation`` and
    ``fault_rate`` are the cell's rates under a participation or fault
    sweep (None: 1.0 and 0.0, bit-identical to the plain round);
    ``robust`` is the cell's aggregation rule (cells with different rules
    run as separate programs)."""

    dataset: str
    topo: Topology
    strategy: str
    ood_k: int = 1
    tau: float = 0.1
    seed: int = 0
    name: str = ""
    sweep: Optional[tuple] = None
    p_fail: float = 0.0
    reactive: bool = False
    ood_ks: Optional[Tuple[int, ...]] = None
    participation: Optional[float] = None
    fault_rate: Optional[float] = None
    robust: str = "mean"

    @property
    def label(self) -> str:
        return self.name or f"{self.dataset}/{self.topo.name}/{self.strategy}"

    def ood_nodes(self) -> Tuple[int, ...]:
        """The OOD host node(s): the ``ood_ks`` degree ranks when set, else
        the ``ood_k``-th highest-degree node."""
        ranks = tuple(self.ood_ks) if self.ood_ks else (self.ood_k,)
        nodes = tuple(self.topo.kth_highest_degree_node(k) for k in ranks)
        if len(set(nodes)) != len(nodes):
            raise ValueError(f"ood_ks {ranks} map to duplicate nodes "
                             f"{nodes} on {self.topo.name}")
        return nodes


def linkfail_cells(datasets=("mnist",), seeds=(0,), n_nodes: int = 16,
                   strategies=("unweighted", "degree"),
                   p_fails=(0.0, 0.3, 0.6), reactive: bool = True,
                   prefix: str = "linkfail") -> List[SweepCell]:
    """Strategies × p_fail on per-seed BA graphs, coefficients from each
    cell's program (``ablations.run_link_failure``'s grid)."""
    cells = []
    for ds in datasets:
        for seed in seeds:
            topo = barabasi_albert(n_nodes, 2, seed=seed)
            for strat in strategies:
                for pf in p_fails:
                    cells.append(SweepCell(
                        ds, topo, strat, ood_k=1, seed=seed, p_fail=pf,
                        reactive=reactive,
                        name=f"{prefix}/{ds}/{strat}/p{pf}",
                        sweep=("p_fail", strat, pf)))
    return cells


def multisource_cells(datasets=("mnist",), seeds=(0,), n_nodes: int = 16,
                      strategies=("unweighted", "degree"),
                      source_counts=(1, 2, 4),
                      prefix: str = "multisource") -> List[SweepCell]:
    """k OOD sources on the k highest-degree nodes of per-seed BA graphs,
    strategies × source counts."""
    cells = []
    for ds in datasets:
        for seed in seeds:
            topo = barabasi_albert(n_nodes, 2, seed=seed)
            for strat in strategies:
                for k in source_counts:
                    cells.append(SweepCell(
                        ds, topo, strat, seed=seed,
                        ood_ks=tuple(range(1, k + 1)),
                        name=f"{prefix}/{ds}/{strat}/k{k}",
                        sweep=("sources", strat, k)))
    return cells


def edges_cells(datasets=("mnist",), seeds=(0,), n_nodes: int = 64,
                strategies=("unweighted", "degree"),
                prefix: str = "edges") -> List[SweepCell]:
    """Strategies × hub placement at a node count where the dense matrix
    is the wrong representation (run with ``mix_impl="edges"``)."""
    cells = []
    for ds in datasets:
        for seed in seeds:
            topo = barabasi_albert(n_nodes, 2, seed=seed)
            for strat in strategies:
                cells.append(SweepCell(
                    ds, topo, strat, ood_k=1, seed=seed,
                    name=f"{prefix}/{ds}/{strat}/n{n_nodes}",
                    sweep=("edges", strat, n_nodes)))
    return cells


def participation_cells(datasets=("mnist",), seeds=(0,), n_nodes: int = 16,
                        strategy: str = "degree", rates=(1.0, 0.7, 0.4),
                        prefix: str = "participation") -> List[SweepCell]:
    """Activation rate × topology (ring, per-seed BA) × OOD placement (hub
    ``ood_k=1``, periphery ``ood_k=n``); rate 1.0 is the synchronous
    control."""
    cells = []
    for ds in datasets:
        for seed in seeds:
            for topo in (ring(n_nodes), barabasi_albert(n_nodes, 2,
                                                        seed=seed)):
                for place, k in (("hub", 1), ("leaf", n_nodes)):
                    for rate in rates:
                        cells.append(SweepCell(
                            ds, topo, strategy, ood_k=k, seed=seed,
                            participation=rate,
                            name=(f"{prefix}/{ds}/{topo.name}/{place}"
                                  f"/r{rate}"),
                            sweep=("participation", topo.name, place, rate)))
    return cells


def byzantine_cells(datasets=("mnist",), seeds=(0,), n_nodes: int = 16,
                    strategy: str = "degree", rates=(0.0, 0.1, 0.3),
                    robusts=("mean", "trimmed", "median"),
                    prefix: str = "byzantine") -> List[SweepCell]:
    """Fault rate × topology (ring, per-seed BA) × OOD placement (hub,
    periphery) × aggregation rule; rate 0.0 is the fault-free control."""
    cells = []
    for ds in datasets:
        for seed in seeds:
            for topo in (ring(n_nodes), barabasi_albert(n_nodes, 2,
                                                        seed=seed)):
                for place, k in (("hub", 1), ("leaf", n_nodes)):
                    for rate in rates:
                        for robust in robusts:
                            cells.append(SweepCell(
                                ds, topo, strategy, ood_k=k, seed=seed,
                                fault_rate=rate, robust=robust,
                                name=(f"{prefix}/{ds}/{topo.name}/{place}"
                                      f"/f{rate}/{robust}"),
                                sweep=("byzantine", topo.name, place, rate,
                                       robust)))
    return cells


def group_cells(cells: List[SweepCell]
                ) -> Dict[Tuple[str, int, str], List[int]]:
    """Cells that share one program: dataset (model and sample shapes),
    node count and robust rule."""
    groups: Dict[Tuple[str, int, str], List[int]] = {}
    for i, cell in enumerate(cells):
        groups.setdefault((cell.dataset, cell.topo.n_nodes, cell.robust),
                          []).append(i)
    return groups


def _pad_cap(leaves: Dict[str, np.ndarray], cap: int) -> Dict[str, np.ndarray]:
    return {k: np.pad(v, [(0, 0), (0, cap - v.shape[1])]
                      + [(0, 0)] * (v.ndim - 2))
            for k, v in leaves.items()}


def run_sweep_cells(cells: List[SweepCell], scale: BenchScale = QUICK,
                    alpha_l: float = 1000.0, alpha_s: float = 1000.0,
                    unroll_eval: bool = False, mesh=None,
                    chunk_rounds: Optional[int] = None,
                    coeff_mode: str = "stack", mix_impl: str = "einsum",
                    analytics: bool = True,
                    arrival_threshold: float = DEFAULT_ARRIVAL_THRESHOLD,
                    participation: Optional[ParticipationSpec] = None,
                    fault: Optional[FaultSpec] = None, log=None,
                    device=None, skip_nonfinite: bool = False,
                    data_fn: Optional[Callable] = None,
                    init_fn: Optional[Callable] = None,
                    checkpoint_dir: Optional[str] = None,
                    resume: bool = False,
                    results: Optional[list] = None) -> List[Dict]:
    """Run a whole grid through the sweep engine, one program a group.

    The reference's arguments: ``coeff_mode`` ``"stack"`` materializes
    each cell's ``(R, n, n)`` stack, ``"program"`` makes the matrices
    round by round (bit-identical for non-reactive programs);
    ``mix_impl`` the backend (``"edges"``/``"sparse"`` get the group's
    union support); ``analytics`` the streaming accumulators;
    ``participation``/``fault`` the specs whose per-cell rates ride the
    batch axis; ``mesh`` (``launch.mesh.make_sweep_mesh``, every rank of
    it calling with the same cells) shards each group's experiment axis
    over its ranks, and only its first rank logs; a rank outside the
    mesh runs nothing and returns ``[]``.
    The port's: ``device`` (None: the card); ``skip_nonfinite`` wraps the
    optimizer in ``skip_nonfinite_updates``; ``data_fn(dataset, n_nodes,
    seed, ood_nodes, scale, steps_per_epoch) -> (batcher, test_iid,
    test_ood)`` and ``init_fn(dataset, seed) -> one node's params``
    replace :func:`cell_data` and the model init (a caller holding its
    own data); ``checkpoint_dir``/``resume`` pass to the engine (chunked
    mode); ``results``, a list, receives ``(cell indices, SweepResult)``
    for each group.  Returns one summary dict per cell, in input order,
    with ``secs`` amortized over the group."""
    if coeff_mode not in ("stack", "program"):
        raise KeyError(f"coeff_mode {coeff_mode!r}; have 'stack', 'program'")
    if mesh is not None and mesh.index < 0:
        return []
    if participation is None and any(c.participation is not None
                                     for c in cells):
        participation = ParticipationSpec()
    if fault is None and any(c.fault_rate is not None for c in cells):
        fault = FaultSpec()
    spec = (AnalyticsSpec(arrival_threshold=arrival_threshold)
            if analytics else None)
    rows: List[Optional[Dict]] = [None] * len(cells)
    for (ds, n_nodes, robust), idxs in group_cells(cells).items():
        t0 = time.time()
        init, loss_fn, acc_fn, opt = _model_fns(ds)
        if init_fn is not None:
            init = functools.partial(init_fn, ds)
        if skip_nonfinite:
            opt = skip_nonfinite_updates(opt)
        mix_support = None
        if mix_impl != "einsum" or robust in ("trimmed", "median"):
            # one static schedule a program: the union of the cells'
            # neighbourhoods (adjacency + self loops)
            mix_support = np.eye(n_nodes)
            for i in idxs:
                mix_support = np.maximum(mix_support,
                                         np.asarray(cells[i].topo.adjacency))
        engine = SweepEngine(
            opt, loss_fn, acc_fn,
            DecentralizedConfig(rounds=scale.rounds,
                                local_epochs=scale.local_epochs,
                                eval_every=scale.eval_every,
                                mix_impl=mix_impl, robust=robust),
            mix_support=mix_support, device=device)

        # distinct data configurations (seed × OOD nodes) → bank rows; one
        # step count for the group (the first batcher's derivation)
        dconf: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        batchers, tbs, obs = [], [], []
        group_steps = scale.steps_per_epoch
        make = data_fn or functools.partial(cell_data, alpha_l=alpha_l,
                                            alpha_s=alpha_s)
        for i in idxs:
            cell = cells[i]
            key = (cell.seed, cell.ood_nodes())
            if key not in dconf:
                nb, tb, ob = make(ds, n_nodes, cell.seed, key[1], scale,
                                  group_steps)
                group_steps = nb.steps
                dconf[key] = len(batchers)
                batchers.append(nb)
                tbs.append(tb)
                obs.append(ob)
        raw_banks = [nb.sample_bank() for nb in batchers]
        cap = max(b[next(iter(b))].shape[1] for b in raw_banks)
        padded = [_pad_cap(b, cap) for b in raw_banks]
        bank = {k: np.stack([p[k] for p in padded]) for k in raw_banks[0]}
        indices = np.stack([nb.all_round_indices(scale.rounds)
                            for nb in batchers])

        reactives = {cells[i].reactive for i in idxs}
        if coeff_mode == "program" and len(reactives) > 1:
            raise ValueError(
                "cells compiled into one program-mode sweep group must "
                "share the `reactive` flag (it is static program "
                "configuration); stack mode materializes per-cell "
                "programs and supports mixed grids")
        data_idx, coeffs, states, p0s, t_iid, t_ood, metas = (
            [], [], [], [], [], [], [])
        program = None
        init_cache: Dict[int, object] = {}
        for i in idxs:
            cell = cells[i]
            ood_nodes = cell.ood_nodes()
            d = dconf[(cell.seed, ood_nodes)]
            data_idx.append(d)
            strategy = AggregationStrategy(cell.strategy, tau=cell.tau,
                                           seed=cell.seed)
            if cell.strategy in PROGRAM_KINDS:
                program, state = program_for(
                    cell.topo, strategy,
                    data_counts=batchers[d].data_counts(),
                    p_fail=cell.p_fail, reactive=cell.reactive)
                if coeff_mode == "program":
                    states.append(state)
                else:
                    coeffs.append(program.materialize(state, scale.rounds))
            else:
                if coeff_mode == "program" or cell.p_fail or cell.reactive:
                    raise ValueError(
                        f"strategy {cell.strategy!r} has no coefficient "
                        f"program (coeff_mode='program' / link-failure "
                        f"cells need one); use coeff_mode='stack'")
                coeffs.append(coeffs_stack(
                    cell.topo, strategy, scale.rounds,
                    data_counts=batchers[d].data_counts()))
            if cell.seed not in init_cache:
                init_cache[cell.seed] = init(cell.seed)
            p0s.append(stack_params([init_cache[cell.seed]] * n_nodes))
            t_iid.append(tbs[d])
            t_ood.append(obs[d])
            metas.append((cell, ood_nodes))

        if coeff_mode == "program":
            # one program serves the group: pruned to the union of its
            # kinds, and without the edge mask when no cell churns links
            program = dataclasses.replace(
                program,
                kinds=tuple(sorted({PROGRAM_KINDS.index(cells[i].strategy)
                                    for i in idxs})),
                link_failure=any(cells[i].p_fail > 0 for i in idxs))
            engine_coeffs = ProgramCoeffs(program, stack_states(states))
        else:
            engine_coeffs = np.stack(coeffs)
        params0 = stack_params(p0s)
        stack_tests = lambda ts: {k: np.stack([np.asarray(t[k]) for t in ts])
                                  for k in ts[0]}
        kw = {}
        if participation is not None:
            kw.update(participation=participation,
                      participation_rates=np.asarray(
                          [1.0 if cells[i].participation is None
                           else cells[i].participation for i in idxs],
                          np.float32))
        if fault is not None:
            kw.update(fault=fault, fault_rates=np.asarray(
                [0.0 if cells[i].fault_rate is None
                 else cells[i].fault_rate for i in idxs], np.float32))
        result = engine.run(
            params0, engine_coeffs, bank, indices, np.asarray(data_idx),
            stack_tests(t_iid), stack_tests(t_ood), batch_size=scale.batch,
            unroll_eval=unroll_eval, mesh=mesh, chunk_rounds=chunk_rounds,
            analytics=spec, checkpoint_dir=checkpoint_dir, resume=resume,
            **kw)
        if results is not None:
            results.append((list(idxs), result))

        secs = time.time() - t0
        for e, (i, (cell, ood_nodes)) in enumerate(zip(idxs, metas)):
            rows[i] = _summary(result, e, cell, ood_nodes, ds, secs,
                               len(idxs), scale, arrival_threshold)
            if log is not None and (mesh is None or mesh.index == 0):
                log(csv_row(cell.label, rows[i]["secs"],
                            f"iid_auc={rows[i]['iid_auc']:.3f};"
                            f"ood_auc={rows[i]['ood_auc']:.3f}"))
    return rows  # type: ignore[return-value]


def _summary(result, e, cell, ood_nodes, ds, secs, group_size, scale,
             arrival_threshold) -> Dict:
    """One cell's row: the host summary, the streaming digest and its
    deviation from the host oracle, the participation and fault
    digests."""
    hist = result.history(e)
    summary = propagation_summary(hist, cell.topo.adjacency, ood_nodes,
                                  arrival_threshold=arrival_threshold)
    summary.update(
        dataset=ds, topology=cell.topo.name, strategy=cell.strategy,
        ood_k=cell.ood_k,
        ood_node=(ood_nodes[0] if len(ood_nodes) == 1 else list(ood_nodes)),
        seed=cell.seed, secs=round(secs / group_size, 2),
        sweep_secs=round(secs, 1), sweep_group_size=group_size)
    if cell.ood_ks:
        summary["ood_ks"] = list(cell.ood_ks)
    if result.analytics is not None:
        stream = {k: v[e] for k, v in result.analytics.items()}
        a = analytics_summary(stream, cell.topo.adjacency, ood_nodes)
        a["stream_vs_host_max_dev"] = float(max(
            np.abs(stream["iid_auc"] - per_node_auc(hist, "iid")).max(),
            np.abs(stream["ood_auc"] - per_node_auc(hist, "ood")).max()))
        summary["analytics"] = a
    if result.participation is not None:
        part = {k: v[e] for k, v in result.participation.items()}
        stream = ({k: v[e] for k, v in result.analytics.items()}
                  if result.analytics is not None else None)
        summary["participation_rate"] = (1.0 if cell.participation is None
                                         else cell.participation)
        summary["participation"] = participation_summary(part, scale.rounds,
                                                         stream)
    if result.fault is not None:
        summary["fault_rate"] = (0.0 if cell.fault_rate is None
                                 else cell.fault_rate)
        summary["robust"] = cell.robust
        summary["fault"] = quarantine_summary(
            {k: v[e] for k, v in result.fault.items()}, scale.rounds)
    if cell.p_fail or cell.reactive:
        summary.update(p_fail=cell.p_fail, reactive=cell.reactive)
    if cell.sweep is not None:
        summary["sweep"] = cell.sweep
    return summary
