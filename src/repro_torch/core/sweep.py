"""Batched experiment-sweep engine (port of ``repro/core/sweep.py``).

The paper's findings are sweeps — over strategies (Fig. 4), OOD placements
(Fig. 5), topologies (Fig. 6) and seeds.  Every cell of such a grid runs
the same program shape (n, R, model, batch geometry); only the data
differ.  :class:`SweepEngine` runs a whole grid as ONE program with the
experiment axis E as a batch dimension: its trees carry leaves ``(E, n,
...)``, LocalTrain folds E into the node axis (one ``torch.func.vmap``
over ``E·n`` nodes), and each round's mix is one launch of a gossip kernel
over the ``(E, n, P)`` plane (``kernels.gossip_mix``, whose grid carries
the experiment index), where the reference ``jax.vmap``s its
``lax.scan`` over E.

Inputs per experiment (leading axis E): ``params0``; ``coeffs`` — an
``(E, R, n, n)`` stack or a :class:`core.coeffs.ProgramCoeffs` whose
matrices are made round by round inside the loop (bit-identical to the
materialized stack for a non-reactive program); ``data_idx`` — the row of
the shared data bank; ``test_iid``/``test_ood`` — leaves ``(E, b, ...)``.
Shared: ``bank`` — the padded per-node sample bank, leaves ``(D, n, cap,
...)`` (``NodeBatcher.sample_bank``), and ``indices`` — the ``(D, R, n,
S)`` index schedule (``NodeBatcher.all_round_indices``).  Both are placed
on the device once; each round's batches are one index gather there
(:func:`gather_round_batch`), of the whole round's ``(E, n, steps, batch,
...)`` batches (at the paper's FFN scale, E = 6: 1.8 GB, gathered per
round; the engine does not gather per local step).

Modes, all one round loop (``core.decentralized.make_scan_fn``) over the
same operations in the same order, so their results are bit-identical:

* **scanned** (default): all R rounds, the history kept on the device and
  copied to the host once;
* **chunked** (``chunk_rounds=c``): ⌈R/c⌉ chunks, the history copied out
  at each chunk's end; with ``checkpoint_dir`` the whole state — params,
  optimizer, every carry and the history so far — is saved at every chunk
  boundary (``training.checkpoint``, atomic), and ``resume=True`` restarts
  from the latest checkpoint, bit for bit the uninterrupted run (the
  environment variable ``REPRO_SWEEP_CRASH_AFTER_CHUNKS=k`` ends the
  process without cleanup after the k-th checkpoint, for kill-and-resume
  tests);
* **unrolled** (``unroll_eval=True``): one round a step, the metrics on
  the host as each round ends.

Nothing in the round loop reads a device value back: masks (participation,
faults, the ``"noise"`` draw) and program matrices depend only on seeds
and round indices, are drawn on the host and uploaded through pinned
memory without a wait.

**Sharded** (``mesh=``, a ``launch.mesh.SweepMesh`` over k ranks, with or
without ``chunk_rounds``): E is padded to a multiple of k with copies of
experiment 0 (:func:`pad_experiments`) and each rank runs the scanned or
chunked loop above over its contiguous block of E/k experiments, on its
own device, with no collective in the loop: every rank builds the grid's
inputs from the same seeds and keeps its block of each per-experiment
input (params, coefficients or program states, data rows, test sets,
rates and seeds, and so every carry).  After the last round the results
(history, params, optimizer state, the analytics, participation and fault
digests) are gathered once in experiment order over the mesh's gloo
group, on host copies, and the padding dropped: every rank returns the
same :class:`SweepResult`, bit for bit the unsharded run's where LocalTrain
gives each experiment the same bits at E/k as at E (the CPU does).  With
``checkpoint_dir`` the whole state is gathered at each chunk boundary and
rank 0 writes it in the unsharded format (E experiments, no padding), so a
checkpoint resumes under any mesh or none; the ranks must share the
directory's filesystem.

:meth:`SweepEngine.traceable` hands out the exact step each mode runs
(``_run_rounds`` on the prepared inputs) for ``repro_torch.analysis``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, to_device
from repro_torch import tree as tree_util
from repro_torch.core.analytics import AnalyticsSpec
from repro_torch.core.coeffs import PROGRAM_KINDS, ProgramCoeffs
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    RoundMetrics,
    eval_round_indices,
    fault_carry_init,
    make_fault_round_fn,
    make_participation_round_fn,
    make_round_fn,
    make_scan_fn,
    node_budget,
    participation_carry_init,
    slice_rows,
    sparse_schedule,
    vmap_in_slices,
)
from repro_torch.core.dynamic import FaultSpec, ParticipationSpec
from repro_torch.training.optimizer import Optimizer

__all__ = ["SweepEngine", "SweepResult", "gather_round_batch",
           "pad_experiments", "CRASH_ENV"]

#: chunk count after which a checkpointing run ends itself (tests)
CRASH_ENV = "REPRO_SWEEP_CRASH_AFTER_CHUNKS"
# the carries' host scalars: inputs of the run, not state to checkpoint
_HOST_KEYS = ("rate", "pseed", "fseed")


def pad_experiments(tree: Any, pad: int) -> Any:
    """Grow every leaf's leading E axis by ``pad`` copies of experiment 0
    (numpy arrays or tensors), so the padded grid runs valid programs
    whose rows the result drops; the tree itself when ``pad == 0``."""
    if pad == 0:
        return tree

    def grow(x):
        if torch.is_tensor(x):
            return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate(
            [x, np.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0)

    return tree_util.tree_map(grow, tree)


def gather_round_batch(bank: Dict[str, torch.Tensor], data_idx, idx_r,
                       batch_size: int) -> Dict[str, torch.Tensor]:
    """One round's node batches gathered from the ``(D, n, cap, ...)``
    bank: ``idx_r`` ``(n, S)`` sample indices (S = steps·batch) with one
    bank row ``data_idx``, or ``(E, n, S)`` with ``(E,)`` rows.  Leaves
    ``(n, steps, batch, ...)`` (``(E, n, ...)``), exactly what
    ``NodeBatcher.round_batches`` yields, the all-ones LM loss mask
    included when the bank holds ``"tokens"``."""
    n, s = idx_r.shape[-2:]
    steps = s // batch_size
    rows = torch.arange(n, device=idx_r.device)[:, None]
    idx_r = idx_r.long()
    if idx_r.ndim == 3:
        data_idx = data_idx.reshape(-1, 1, 1)

    def g(leaf):
        out = leaf[data_idx, rows, idx_r]
        return out.reshape(tuple(idx_r.shape[:-1]) + (steps, batch_size)
                           + tuple(leaf.shape[3:]))

    batch = {k: g(v) for k, v in bank.items()}
    if "tokens" in batch:   # LM: the trainer consumes an all-ones mask
        toks = batch["tokens"]
        batch["mask"] = torch.ones(toks.shape[:-1] + (toks.shape[-1] - 1,),
                                   dtype=torch.float32, device=toks.device)
    return batch


@dataclasses.dataclass
class SweepResult:
    """Stacked metrics of an E-experiment sweep.

    ``train_loss`` / ``iid_acc`` / ``ood_acc`` are ``(E, R, n)`` numpy
    arrays (accuracies zero on rounds without eval); ``params`` is the
    final tree, leaves ``(E, n, ...)`` on the engine's device.
    ``history(e)`` rebuilds experiment e's ``List[RoundMetrics]`` at the
    eval rounds, as ``DecentralizedTrainer.run`` returns it.
    ``analytics`` holds the finalized streaming summaries (``(E, n)``
    arrays: ``iid_auc``, ``ood_auc``, ``gap_pct``, ``iid_arrival``,
    ``ood_arrival``, ``final_iid_acc``, ``final_ood_acc``); with
    ``keep_history=False`` they are the only metrics and the per-round
    arrays are ``(E, 0, n)``.  ``participation`` (``rounds_active``,
    ``final_staleness``, ``mean_staleness``, ``local_steps``) and
    ``fault`` (``fault_rounds``, ``rounds_quarantined``,
    ``quar_fault_rounds``, ``first_fault``, ``first_quar``) are ``(E, n)``
    digests of their carries.  ``opt_state`` is the final optimizer state
    (leaves ``(E, n, ...)``; the nonfinite guard's ``skipped`` counts)."""

    train_loss: np.ndarray
    iid_acc: np.ndarray
    ood_acc: np.ndarray
    params: Any
    eval_every: int = 1
    analytics: Optional[Dict[str, np.ndarray]] = None
    participation: Optional[Dict[str, np.ndarray]] = None
    fault: Optional[Dict[str, np.ndarray]] = None
    opt_state: Any = None

    @property
    def n_experiments(self) -> int:
        return self.train_loss.shape[0]

    @property
    def rounds(self) -> int:
        return self.train_loss.shape[1]

    def history(self, e: int) -> List[RoundMetrics]:
        return [RoundMetrics(round=r, iid_acc=self.iid_acc[e, r],
                             ood_acc=self.ood_acc[e, r],
                             train_loss=self.train_loss[e, r])
                for r in eval_round_indices(self.rounds, self.eval_every)]

    def experiment_params(self, e: int):
        return tree_util.tree_map(lambda x: x[e], self.params)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _device_state(carry):
    """A carry without its host scalars (rates and seeds)."""
    if not carry:
        return {}
    return {k: v for k, v in carry.items() if k not in _HOST_KEYS}


@dataclasses.dataclass
class _Run:
    """A run's inputs on the device and its state between chunks."""

    params: Any
    opt: Any
    pcarry: Any
    fcarry: Any
    acarry: Any
    coeffs: Any              # (R, E, n, n) device tensor, or None (program)
    program: Optional[ProgramCoeffs]
    idx: torch.Tensor        # (R, E, n, S) int32 on the device
    data_idx: torch.Tensor   # (E,) long on the device
    bank: Dict[str, torch.Tensor]
    test_iid: Any
    test_ood: Any
    eval_mask: np.ndarray
    rounds: int
    n_exp: int
    n_nodes: int


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's contiguous block ``[lo, hi)`` of the experiment axis
    padded to a multiple of the mesh size."""

    mesh: Any
    n_exp: int       # experiments before padding
    pad: int
    lo: int
    hi: int

    @classmethod
    def of(cls, mesh, n_exp: int) -> "_Shard":
        if mesh.index < 0:
            raise ValueError(f"rank {dist.get_rank()} is outside the sweep "
                             f"mesh's ranks {mesh.ranks}")
        pad = (-n_exp) % mesh.size
        per = (n_exp + pad) // mesh.size
        return cls(mesh, n_exp, pad, mesh.index * per,
                   (mesh.index + 1) * per)

    @property
    def lead(self) -> bool:
        return self.mesh.index == 0

    def take(self, tree):
        """This rank's block of every leaf's padded E axis."""
        return tree_util.tree_map(lambda x: x[self.lo:self.hi],
                                  pad_experiments(tree, self.pad))

    def gather(self, tree):
        """Every rank's block of each leaf (device tensors, host tensors or
        numpy) in experiment order, the padding dropped: host tensors (numpy
        for numpy leaves), one all-gather a leaf over the gloo group."""
        from repro_torch.core.gossip import _all_gather

        def one(x):
            as_numpy = isinstance(x, np.ndarray)
            t = (torch.from_numpy(np.ascontiguousarray(x)) if as_numpy
                 else x.detach().cpu().contiguous())
            shape = (self.mesh.size * t.shape[0],) + tuple(t.shape[1:])
            out = torch.empty(shape, dtype=t.dtype)
            if t.numel():
                _all_gather(out, t, self.mesh.group)
            out = out[:self.n_exp]
            return out.numpy() if as_numpy else out

        return tree_util.tree_map(one, tree)

    def gather_result(self, res: "SweepResult", device) -> "SweepResult":
        to_dev = lambda t: tree_util.tree_map(lambda x: x.to(device), t)
        return dataclasses.replace(
            res, train_loss=self.gather(res.train_loss),
            iid_acc=self.gather(res.iid_acc),
            ood_acc=self.gather(res.ood_acc),
            params=to_dev(self.gather(res.params)),
            opt_state=to_dev(self.gather(res.opt_state)),
            analytics=self.gather(res.analytics),
            participation=self.gather(res.participation),
            fault=self.gather(res.fault))


class SweepEngine:
    """Runs (strategy × seed × placement × topology) grids as one program.

    Args:
      optimizer / loss_fn / eval_fn: as ``DecentralizedTrainer`` (per node).
      config: round and epoch counts, the mix backend (``mix_impl="pallas"``
        is the fused-plane kernel), the robust rule, ``eval_every``;
        ``unroll_eval=True`` makes :meth:`run` default to the unrolled
        mode.
      mix_support: the ``(n, n)`` union support that ``"edges"``,
        ``"sparse"`` and the trimmed/median rules need (their static
        tables or offsets); :meth:`run` refuses coefficients with weight
        outside it.
      device: where the run happens; ``None`` is the CUDA card (raising
        when there is none).
    """

    def __init__(self, optimizer: Optimizer, loss_fn: Callable,
                 eval_fn: Callable,
                 config: DecentralizedConfig = DecentralizedConfig(),
                 mix_support: Optional[np.ndarray] = None, device=None):
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.config = config
        self.device = resolve_device(device)
        self._mix_support = mix_support
        self._round_fns: Dict[Any, Callable] = {}
        self._eval_node = torch.func.vmap(eval_fn, in_dims=(0, None))
        self._eval_grid = torch.func.vmap(self._eval_node, in_dims=(0, 0))

    def _mix_kwargs(self) -> dict:
        c = self.config
        return dict(mix_impl=c.mix_impl, epoch_shuffle=c.epoch_shuffle,
                    mix_support=self._mix_support,
                    sparse_slack=c.sparse_slack,
                    mix_in_float32=c.mix_in_float32, robust=c.robust,
                    robust_trim=c.robust_trim, robust_clip=c.robust_clip,
                    device=self.device)

    def _round_fn(self, participation: Optional[ParticipationSpec],
                  fault: Optional[FaultSpec]) -> Callable:
        """The round of this signature, built once (the edge tables go to
        the device at build time)."""
        key = (participation, fault)
        fn = self._round_fns.get(key)
        if fn is None:
            c = self.config
            if fault is not None:
                fn = make_fault_round_fn(self.loss_fn, self.optimizer,
                                         c.local_epochs, fault,
                                         participation=participation,
                                         **self._mix_kwargs())
            elif participation is not None:
                fn = make_participation_round_fn(
                    self.loss_fn, self.optimizer, c.local_epochs,
                    participation, **self._mix_kwargs())
            else:
                fn = make_round_fn(self.loss_fn, self.optimizer,
                                   c.local_epochs, **self._mix_kwargs())
            self._round_fns[key] = fn
        return fn

    def _evaluate(self, params, test_iid, test_ood):
        """``(E, n)`` IID and OOD accuracies: experiment e's nodes on its
        own test batches."""
        return (self._eval_pieces(params, test_iid),
                self._eval_pieces(params, test_ood))

    def _eval_pieces(self, params, test) -> torch.Tensor:
        """One test set over the ``(E, n)`` grid in one call where it fits
        the node budget (``core.decentralized.slice_rows``), else each
        experiment's node axis in slices."""
        e, n = tree_util.leaves(params)[0].shape[:2]
        one = tree_util.tree_map(lambda x: x[0], test)
        rows = slice_rows(self.eval_fn, one, e * n, node_budget(self.device))
        if rows >= e * n:
            return self._eval_grid(params, test)
        return torch.stack([
            vmap_in_slices(
                self._eval_node, tree_util.tree_map(lambda x: x[i], params),
                tree_util.tree_map(lambda x: x[i], test), rows)
            for i in range(e)])

    # ------------------------------------------------------------------
    def _check_support(self, coeffs) -> None:
        """:meth:`_check_sparse_support` for the backends and rules that
        need it, on a stack or a ``ProgramCoeffs``."""
        if (self.config.mix_impl in ("sparse", "edges")
                or self.config.robust in ("trimmed", "median")):
            if isinstance(coeffs, ProgramCoeffs):
                self._check_sparse_support(None, coeffs)
            else:
                self._check_sparse_support(np.asarray(coeffs, np.float32),
                                           None)

    def _check_sparse_support(self, coeffs, program) -> None:
        """``"edges"``, ``"sparse"`` and the order-statistic rules drop
        weight outside their static tables or offsets: refuse a grid whose
        coefficients carry any (sub-stochastic mixing would be quietly
        wrong).  The circulant dense fallback covers everything."""
        if self._mix_support is None:
            return   # make_round_fn raises for the impls that need it
        s = np.asarray(self._mix_support)
        if (self.config.mix_impl == "edges"
                or self.config.robust in ("trimmed", "median")):
            covered = (s > 0) | np.eye(s.shape[0], dtype=bool)
        else:
            _, covered = sparse_schedule(s, self.config.sparse_slack)
            if covered is None:
                return
        if program is None:
            used = np.any(np.abs(coeffs) > 1e-12, axis=(0, 1))
        else:
            adj = np.asarray(program.states["adj"])
            n = adj.shape[-1]
            used = (np.abs(adj).max(axis=0) > 0) | np.eye(n, dtype=bool)
            if np.any(np.asarray(program.states["kind"])
                      == PROGRAM_KINDS.index("fl")):
                used = np.ones_like(used)   # fl's matrix is dense 1/n
        if np.any(used & ~covered):
            raise ValueError(
                f"mix_impl={self.config.mix_impl!r}: coefficients carry "
                "weight outside the mix_support schedule (ring offsets / "
                "neighbour tables), which the sparse mix would silently "
                "drop (sub-stochastic mixing); widen mix_support or use "
                "mix_impl='einsum'")

    def _prepare(self, params0, coeffs, bank, indices, data_idx, test_iid,
                 test_ood, analytics, keep_history, participation,
                 participation_rates, participation_seeds, fault,
                 fault_rates, fault_seeds) -> _Run:
        dev = self.device
        program = None
        if isinstance(coeffs, ProgramCoeffs):
            program = coeffs
            program.program.validate_state_kinds(program.states)
            rounds = int(np.asarray(indices).shape[1])
            coeffs_np = None
        else:
            coeffs_np = np.asarray(coeffs, np.float32)
            rounds = coeffs_np.shape[1]
        self._check_support(coeffs)
        if not keep_history and analytics is None:
            raise ValueError("keep_history=False without an analytics "
                             "spec would return no metrics at all")
        # every input goes up through pinned memory without a wait, so no
        # step of a run, its set-up included, blocks on the card
        put = lambda t: tree_util.tree_map(
            lambda x: to_device(np.array(x) if isinstance(x, np.ndarray)
                                else x, dev), t)
        params0 = tree_util.tree_map(
            lambda x: to_device(x if torch.is_tensor(x) else np.array(x),
                                dev).clone(), params0)
        leaf = tree_util.leaves(params0)[0]
        n_exp, n_nodes = int(leaf.shape[0]), int(leaf.shape[1])
        data_np = np.asarray(data_idx, np.int64)
        idx = np.asarray(indices, np.int32)[data_np]          # (E, R, n, S)
        flat = lambda t: tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]), t)
        opt0 = tree_util.tree_map(
            lambda x: x.reshape((n_exp, n_nodes) + x.shape[1:]),
            self.optimizer.init(flat(params0)))
        eval_mask = np.zeros(rounds, bool)
        eval_mask[eval_round_indices(rounds, self.config.eval_every)] = True
        acarry = (analytics.init_batch(n_exp, n_nodes, dev)
                  if analytics is not None else {})
        pcarry = fcarry = {}
        if participation is None:
            if participation_rates is not None or \
                    participation_seeds is not None:
                raise ValueError("participation_rates/participation_seeds "
                                 "need a ParticipationSpec (participation=)")
        else:
            rates, seeds = _rates_and_seeds(
                participation_rates, participation_seeds, 1.0,
                participation.seed, n_exp)
            pcarry = participation_carry_init(params0, rates, seeds)
        if fault is None:
            if fault_rates is not None or fault_seeds is not None:
                raise ValueError("fault_rates/fault_seeds need a FaultSpec "
                                 "(fault=)")
        else:
            rates, seeds = _rates_and_seeds(fault_rates, fault_seeds, 0.0,
                                           fault.seed, n_exp)
            fcarry = fault_carry_init(params0, rates, seeds)
        return _Run(
            params=params0, opt=opt0, pcarry=pcarry, fcarry=fcarry,
            acarry=acarry,
            coeffs=(None if coeffs_np is None else
                    to_device(coeffs_np, dev).transpose(0, 1)),
            program=program,
            idx=to_device(idx, dev).transpose(0, 1),
            data_idx=to_device(data_np, dev),
            bank=put(bank), test_iid=put(test_iid), test_ood=put(test_ood),
            eval_mask=eval_mask, rounds=rounds, n_exp=n_exp,
            n_nodes=n_nodes)

    # ------------------------------------------------------------------
    def _run_rounds(self, run: _Run, a: int, b: int, batch_size: int,
                    analytics, keep_history, participation, fault):
        """Rounds ``[a, b)`` from the run's state; returns the history of
        those rounds, ``(E, b − a, n)`` device tensors, or None."""
        coeff_fn = None
        if run.program is None:
            coeffs = run.coeffs[a:b]
        else:
            coeffs = np.arange(a, b)
            coeff_fn = lambda r: to_device(run.program.matrices(r),
                                           self.device)
        scan = make_scan_fn(
            self._round_fn(participation, fault), self._evaluate,
            make_batch=lambda ix: gather_round_batch(
                run.bank, run.data_idx, ix, batch_size),
            coeff_fn=coeff_fn, analytics=analytics,
            keep_history=keep_history, participation=participation,
            fault=fault)
        kwargs = {}
        if analytics is not None:
            kwargs["analytics_carry"] = run.acarry
        if participation is not None:
            kwargs["participation_carry"] = run.pcarry
        if fault is not None:
            kwargs["fault_carry"] = run.fcarry
        out = list(scan(run.params, run.opt, run.idx[a:b], coeffs,
                        run.eval_mask[a:b], run.test_iid, run.test_ood,
                        round_idx=np.arange(a, b), **kwargs))
        run.params, run.opt = out.pop(0), out.pop(0)
        if participation is not None:
            run.pcarry = out.pop(0)
        if fault is not None:
            run.fcarry = out.pop(0)
        if analytics is not None:
            run.acarry = out.pop(0)
        if not keep_history:
            return None
        return tuple(h.transpose(0, 1) for h in out)   # (E, R_chunk, n)

    def run(self, params0, coeffs, bank, indices, data_idx, test_iid,
            test_ood, batch_size: int, unroll_eval: Optional[bool] = None,
            mesh=None, chunk_rounds: Optional[int] = None,
            analytics: Optional[AnalyticsSpec] = None,
            keep_history: bool = True,
            participation: Optional[ParticipationSpec] = None,
            participation_rates=None, participation_seeds=None,
            fault: Optional[FaultSpec] = None, fault_rates=None,
            fault_seeds=None, checkpoint_dir: Optional[str] = None,
            resume: bool = False) -> SweepResult:
        """Run the whole grid (the reference's arguments; the numpy or
        tensor inputs are placed on the engine's device once).

        ``params0`` leaves ``(E, n, ...)``; ``coeffs`` an ``(E, R, n, n)``
        stack or a ``ProgramCoeffs`` (R then comes from ``indices``);
        ``bank`` leaves ``(D, n, cap, ...)``; ``indices`` ``(D, R, n, S)``;
        ``data_idx`` ``(E,)``; ``test_iid``/``test_ood`` leaves ``(E, b,
        ...)``.  ``unroll_eval`` overrides ``config.unroll_eval``;
        ``chunk_rounds`` runs the chunked mode; ``analytics`` threads the
        streaming accumulators (``keep_history=False`` then drops the
        per-round arrays); ``participation``/``fault`` switch every round
        to those signatures with ``(E,)`` rates and seeds carried as data
        (None: rate 1.0 / 0.0, seeds ``spec.seed + arange(E)``);
        ``checkpoint_dir`` (needs ``chunk_rounds``) saves the state at
        every chunk boundary and ``resume=True`` restarts from the latest
        one (a fresh start when there is none).  ``mesh`` (a
        ``launch.mesh.SweepMesh``, every rank of it calling ``run`` with
        the same inputs) shards the experiment axis over its ranks."""
        unroll = self.config.unroll_eval if unroll_eval is None \
            else unroll_eval
        if unroll and (mesh is not None or chunk_rounds):
            raise ValueError("mesh/chunk_rounds are scanned-mode options; "
                             "they cannot combine with unroll_eval=True")
        if checkpoint_dir is not None and not chunk_rounds:
            raise ValueError("checkpoint_dir needs chunk_rounds: "
                             "checkpoints are written at chunk boundaries")
        shard, run = self._shard_and_prepare(
            mesh, params0, coeffs, bank, indices, data_idx, test_iid,
            test_ood, analytics, keep_history, participation,
            participation_rates, participation_seeds, fault, fault_rates,
            fault_seeds)
        chunk = 1 if unroll else (chunk_rounds or run.rounds)
        hist: List[tuple] = []
        start = 0
        if checkpoint_dir is not None and resume:
            start, hist = self._resume(checkpoint_dir, run, keep_history,
                                       shard)
        crash_after = int(os.environ.get(CRASH_ENV, "0"))
        chunks_done = 0
        for a in range(start, run.rounds, chunk):
            b = min(a + chunk, run.rounds)
            h = self._run_rounds(run, a, b, batch_size, analytics,
                                 keep_history, participation, fault)
            if h is not None:
                # unrolled and chunked: the metrics on the host as each
                # step or chunk ends; scanned: once, at the end
                hist.append(tuple(map(_numpy, h)))
            chunks_done += 1
            if checkpoint_dir is not None and b < run.rounds:
                state, history = _state_tree(run), _history(hist)
                if shard is not None:   # the whole grid, in E order
                    state, history = shard.gather((state, history))
                if shard is None or shard.lead:
                    _save_checkpoint(checkpoint_dir, b, state, history,
                                     keep_history)
                if shard is not None:
                    dist.barrier(shard.mesh.group)
                if crash_after and chunks_done >= crash_after:
                    os._exit(17)   # a preempted host: no cleanup at all
        res = self._result(run, hist, analytics, participation, fault,
                           keep_history)
        return res if shard is None else shard.gather_result(res,
                                                             self.device)

    def _shard_and_prepare(self, mesh, params0, coeffs, bank, indices,
                           data_idx, test_iid, test_ood, analytics,
                           keep_history, participation, participation_rates,
                           participation_seeds, fault, fault_rates,
                           fault_seeds):
        """``(shard, run)``: with a mesh, this rank's block of every
        per-experiment input (``shard`` None without one), then
        :meth:`_prepare`."""
        shard = None
        if mesh is not None:
            self._check_support(coeffs)   # on every rank, the whole grid
            n_exp = int(tree_util.leaves(params0)[0].shape[0])
            shard = _Shard.of(mesh, n_exp)
            if participation is not None:
                participation_rates, participation_seeds = shard.take(
                    _rates_and_seeds(participation_rates,
                                     participation_seeds, 1.0,
                                     participation.seed, n_exp))
            if fault is not None:
                fault_rates, fault_seeds = shard.take(_rates_and_seeds(
                    fault_rates, fault_seeds, 0.0, fault.seed, n_exp))
            if isinstance(coeffs, ProgramCoeffs):
                coeffs = dataclasses.replace(coeffs,
                                             states=shard.take(coeffs.states))
            else:
                coeffs = shard.take(np.asarray(coeffs, np.float32))
            params0, data_idx, test_iid, test_ood = shard.take(
                (params0, np.asarray(data_idx), test_iid, test_ood))
        run = self._prepare(params0, coeffs, bank, indices, data_idx,
                            test_iid, test_ood, analytics, keep_history,
                            participation, participation_rates,
                            participation_seeds, fault, fault_rates,
                            fault_seeds)
        return shard, run

    def traceable(self, params0, coeffs, bank, indices, data_idx, test_iid,
                  test_ood, batch_size: int, mode: str = "scanned",
                  mesh=None, chunk_rounds: Optional[int] = None,
                  analytics: Optional[AnalyticsSpec] = None,
                  keep_history: bool = True,
                  donate: Optional[bool] = None,
                  participation: Optional[ParticipationSpec] = None,
                  participation_rates=None, participation_seeds=None,
                  fault: Optional[FaultSpec] = None, fault_rates=None,
                  fault_seeds=None):
        """``(fn, args, kwargs)`` for ``repro_torch.analysis``: the step
        :meth:`run` executes for each mode, ``fn(*args, **kwargs)``
        returning that step's history (``(E, rounds, n)`` loss, IID, OOD on
        the device) and leaving the state in ``args[0]``, the prepared
        ``_Run`` (its ``params`` and ``opt`` are the carry).  The
        reference's arguments; the inputs as :meth:`run` takes them.

        ``mode``: ``"scanned"`` all rounds; ``"chunked"`` the first chunk
        of ``chunk_rounds``; ``"unrolled"`` the first round, with its
        evaluation (the reference's unrolled step evaluates, as a run of
        one round does); ``"mesh"`` this rank's block of the grid over
        ``mesh`` (a ``launch.mesh.SweepMesh``; default
        ``make_sweep_mesh()`` over the world, which needs a process
        group), all rounds.  ``donate`` (default: True for ``"chunked"``
        and ``"mesh"``, False otherwise) is the reference's donation of
        the ``(params, opt)`` carry: the engine's step drops its input
        carry as it goes; ``donate=False`` gives a step that keeps it
        alive, as a step whose inputs are not donated leaves them valid.
        """
        if mode not in ("scanned", "chunked", "mesh", "unrolled"):
            raise KeyError(f"unknown mode {mode!r}; have 'scanned', "
                           f"'chunked', 'mesh', 'unrolled'")
        if mode == "mesh" and mesh is None:
            from repro_torch.launch.mesh import make_sweep_mesh

            mesh = make_sweep_mesh()
        _, run = self._shard_and_prepare(
            mesh if mode == "mesh" else None, params0, coeffs, bank,
            indices, data_idx, test_iid, test_ood, analytics, keep_history,
            participation, participation_rates, participation_seeds, fault,
            fault_rates, fault_seeds)
        b = {"scanned": run.rounds, "mesh": run.rounds,
             "chunked": min(chunk_rounds or run.rounds, run.rounds),
             "unrolled": 1}[mode]
        if mode == "unrolled":
            run.eval_mask[0] = True
        # the round function (its neighbour tables placed on the device)
        # is set-up, built once an engine: the step is the round loop
        self._round_fn(participation, fault)
        fn = functools.partial(
            self._run_rounds, batch_size=batch_size, analytics=analytics,
            keep_history=keep_history, participation=participation,
            fault=fault)
        if donate is None:
            donate = mode in ("chunked", "mesh")
        if not donate:
            fn = functools.partial(_keeping_inputs, fn,
                                   (run.params, run.opt))
        return fn, (run, 0, b), {}

    def _result(self, run: _Run, hist, analytics, participation, fault,
                keep_history) -> SweepResult:
        if keep_history and hist:
            loss, iid, ood = (np.concatenate([h[i] for h in hist], axis=1)
                              for i in range(3))
        else:
            loss = iid = ood = np.zeros((run.n_exp, 0, run.n_nodes),
                                        np.float32)
        a_out = p_out = f_out = None
        if analytics is not None:
            a_out = {k: _numpy(v)
                     for k, v in analytics.finalize(run.acarry).items()}
        if participation is not None:
            pc = run.pcarry
            p_out = {"rounds_active": _numpy(pc["rounds_active"]),
                     "final_staleness": _numpy(pc["staleness"]),
                     "mean_staleness": (_numpy(pc["staleness_sum"])
                                        .astype(np.float64)
                                        / max(run.rounds, 1)),
                     "local_steps": _numpy(pc["local_steps"])}
        if fault is not None:
            f_out = {k: _numpy(run.fcarry[k])
                     for k in ("fault_rounds", "rounds_quarantined",
                               "quar_fault_rounds", "first_fault",
                               "first_quar")}
        return SweepResult(train_loss=loss, iid_acc=iid, ood_acc=ood,
                           params=run.params,
                           eval_every=self.config.eval_every,
                           analytics=a_out, participation=p_out,
                           fault=f_out, opt_state=run.opt)

    def _resume(self, directory: str, run: _Run, keep_history: bool,
                shard: Optional[_Shard] = None):
        """Restore the latest checkpoint into ``run`` (this rank's block of
        it under a mesh); ``(rounds done, history chunks)``, ``(0, [])``
        when there is none."""
        from repro_torch.training.checkpoint import latest_checkpoint

        path = latest_checkpoint(directory)
        if path is None:
            return 0, []
        skeleton = _state_tree(run)
        n_exp = run.n_exp
        if shard is not None:   # the file holds all E experiments
            n_exp = shard.n_exp
            skeleton = tree_util.tree_map(
                lambda x: torch.empty((n_exp,) + tuple(x.shape[1:]),
                                      dtype=x.dtype), skeleton)
        state, hist, done = _load_checkpoint(path, skeleton, n_exp,
                                             run.n_nodes, keep_history)
        if shard is not None:
            state, hist = shard.take((state, hist))
            state = tree_util.tree_map(lambda x: x.to(self.device), state)
        run.params, run.opt = state["params"], state["opt"]
        run.acarry = state["acarry"]
        run.pcarry = {**run.pcarry, **state["pcarry"]}
        run.fcarry = {**run.fcarry, **state["fcarry"]}
        return done, hist


def _keeping_inputs(step, kept, *args, **kwargs):
    """``step(*args, **kwargs)``; ``kept``, the step's input carry bound
    into the partial, stays referenced as long as the step does: the
    counterpart of a step without donation."""
    return step(*args, **kwargs)


def _rates_and_seeds(rates, seeds, default_rate: float, seed0: int,
                    n_exp: int):
    """``(E,)`` f32 rates and seeds from scalars, arrays or None."""
    r = (np.full(n_exp, default_rate, np.float32) if rates is None
         else np.broadcast_to(np.asarray(rates, np.float32), (n_exp,)))
    s = (np.asarray(seed0 + np.arange(n_exp), np.int64) if seeds is None
         else np.broadcast_to(np.asarray(seeds, np.int64), (n_exp,)))
    return np.array(r), np.array(s)


def _state_tree(run: _Run) -> dict:
    return {"params": run.params, "opt": run.opt, "acarry": run.acarry,
            "pcarry": _device_state(run.pcarry),
            "fcarry": _device_state(run.fcarry)}


def _history(hist) -> Optional[dict]:
    """The history chunks so far as ``(E, rounds, n)`` tensors, or None."""
    if not hist:
        return None
    return {name: torch.from_numpy(np.concatenate([h[i] for h in hist],
                                                  axis=1))
            for i, name in enumerate(("losses", "iids", "oods"))}


def _save_checkpoint(directory: str, rounds_done: int, state, history,
                     keep_history: bool) -> str:
    """The whole chunk-boundary state — params, optimizer, every carry and
    the history so far (:func:`_history`) — as one atomic checkpoint: the
    state rides the params slot and the history the optimizer slot."""
    from repro_torch.training.checkpoint import save_checkpoint

    return save_checkpoint(directory, rounds_done, state,
                           history if keep_history else None,
                           metadata={"rounds_done": int(rounds_done),
                                     "keep_history": bool(keep_history)})


def _load_checkpoint(path: str, skeleton, n_exp: int, n_nodes: int,
                     keep_history: bool):
    """Restore into the skeleton of the run's state (E = ``n_exp``), so a
    checkpoint of another shape fails loudly with the offending leaf; the
    history as one chunk of numpy arrays."""
    from repro_torch.training.checkpoint import load_checkpoint

    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
    except (zipfile.BadZipFile, zlib.error, EOFError) as e:
        raise ValueError(f"{path}: truncated or corrupt checkpoint ({e})")
    done = int(meta["rounds_done"])
    if keep_history and done:
        h = torch.zeros((n_exp, done, n_nodes), dtype=torch.float32)
        state, hist, _ = load_checkpoint(
            path, skeleton, {"losses": h, "iids": h, "oods": h})
        hist = [tuple(hist[k].numpy() for k in ("losses", "iids", "oods"))]
    else:
        state, _, _ = load_checkpoint(path, skeleton)
        hist = []
    return state, hist, done
