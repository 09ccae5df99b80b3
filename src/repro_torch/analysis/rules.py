"""The rule catalog and the :func:`analyze` entry point (port of
``repro/analysis/rules.py``).

The same five rules, by name and contract, as the reference's.  Each is a
frozen dataclass with a registered ``name`` and a ``check(ctx) ->
List[Finding]`` method over an :class:`AnalysisContext`: the events that
:class:`~repro_torch.analysis.walker.OpRecorder` recorded while the
program ran (the reference reads its traced jaxpr).  A rule that must see
the program's inputs before it runs (``Donation``) also has a
``before(fn, args, kwargs)`` hook.

Scopes: ``"all"`` is the whole run; ``"round"`` the first round of the
round loop (``walker.round_scope``; the whole run when it has no round),
the counterpart of the reference's ``"scan_body"``.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.analysis.report import Finding, Report, RuleOutcome
from repro_torch.analysis.walker import (
    KERNEL_REGIONS,
    MATMUL_OPS,
    OpRecorder,
    RegionEntry,
    Upload,
    count_calls,
    count_ops,
    iter_ops,
    round_scope,
)

__all__ = [
    "AnalysisContext",
    "Rule",
    "FusionBudget",
    "ConstantFootprint",
    "DtypeFlow",
    "Donation",
    "HostSync",
    "analyze",
    "SYNC_OPS",
]

#: aten ops that read a device value back to the host, or whose output
#: shape depends on the data (so the host must wait for it): inside the
#: round loop each would serialize every round on a host round-trip.
SYNC_OPS: Tuple[str, ...] = (
    "_local_scalar_dense", "item", "nonzero", "masked_select", "unique",
    "_unique", "_unique2", "unique_consecutive", "unique_dim")
_COPIES = ("_to_copy", "copy_", "_copy_from", "_copy_from_and_resize")
_SMALL_FLOATS = (torch.bfloat16, torch.float16)


def _path_str(path) -> str:
    return "/".join(name for name, _ in path)


@dataclasses.dataclass
class AnalysisContext:
    """What a run exposes to the rules: its recorded ``events``, the device
    type its tensors lived on, a sync the card refused
    (``set_sync_debug_mode("error")``), and each rule's ``before`` state."""

    events: list
    name: str = "<fn>"
    device_type: str = "cpu"
    sync_error: Optional[str] = None
    before: Dict[int, Any] = dataclasses.field(default_factory=dict)

    def scoped(self, scope: str) -> list:
        if scope == "all":
            return self.events
        if scope == "round":
            return round_scope(self.events)
        raise ValueError(f"unknown scope {scope!r}; have 'all', 'round'")


@dataclasses.dataclass(frozen=True)
class Rule:
    """Base class: a named, parameterized contract check."""

    name = "rule"

    def before(self, fn, args, kwargs) -> Any:
        return None

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        raise NotImplementedError

    def _finding(self, message: str, path: str = "") -> Finding:
        return Finding(rule=self.name, message=message, path=path)


@dataclasses.dataclass(frozen=True)
class FusionBudget(Rule):
    """Exact counts of kernel calls and matrix products — the fusion
    contract.

    ``budget`` maps a key to the exact count the scoped run must show: a
    kernel wrapper's name (``"gossip_plane"``: its calls, the entries of
    its region), ``"kernel_call"`` (the calls of every kernel wrapper, the
    reference's ``pallas_call``), ``"matmul"`` (aten ``mm``/``bmm``/
    ``addmm``/``baddbmm`` and the other :data:`walker.MATMUL_OPS`, the
    reference's ``dot_general``) or any aten op name.  Ops inside a kernel
    region (a plain version on the CPU) are not counted: they are the
    kernel's.  Expected budgets come from
    ``core.decentralized.mix_impl_budget`` /
    ``kernels.gossip_mix.mix_eqn_budget``.
    """

    budget: Tuple[Tuple[str, int], ...] = ()
    scope: str = "round"
    name = "fusion-budget"

    @staticmethod
    def of(budget: Dict[str, int], scope: str = "round") -> "FusionBudget":
        return FusionBudget(budget=tuple(sorted(budget.items())), scope=scope)

    def measure(self, ctx: AnalysisContext) -> Dict[str, object]:
        events = ctx.scoped(self.scope)
        calls = count_calls(events)
        ops = count_ops(events)
        out = {}
        for key, _ in self.budget:
            if key == "kernel_call":
                out[key] = sum(calls.values())
            elif key in KERNEL_REGIONS:
                out[key] = calls.get(key, 0)
            elif key == "matmul":
                out[key] = sum(ops.get(op, 0) for op in MATMUL_OPS)
            else:
                out[key] = ops.get(key, 0)
        return out

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        got = self.measure(ctx)
        return [self._finding(f"{key}: expected exactly {want} in scope "
                              f"{self.scope!r}, found {got[key]}")
                for key, want in self.budget if got[key] != want]


@dataclasses.dataclass(frozen=True)
class ConstantFootprint(Rule):
    """Bound the bytes uploaded inside the round.

    The engine keeps per-round data (coefficient stacks, index schedules,
    banks) on the device from the start; each round uploads only what it
    draws on the host (a program's matrices, participation and fault
    masks) through ``repro_torch.to_device``.  An ``(R, n, n)`` stack
    uploaded, or built and uploaded, inside a round is the regression this
    catches (the reference's constant-folded slab).  ``max_total_bytes``
    caps the sum over the scope's uploads, ``max_upload_bytes`` any one.
    """

    max_total_bytes: int = 1 << 20
    max_upload_bytes: Optional[int] = None
    name = "constant-footprint"

    def _uploads(self, ctx) -> List[Upload]:
        return [ev for ev in ctx.scoped("round") if isinstance(ev, Upload)]

    def measure(self, ctx: AnalysisContext) -> Dict[str, object]:
        ups = self._uploads(ctx)
        return {"n_uploads": len(ups),
                "total_bytes": sum(u.meta.nbytes for u in ups)}

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        ups = self._uploads(ctx)
        total = sum(u.meta.nbytes for u in ups)
        findings = []
        if self.max_upload_bytes is not None:
            for u in ups:
                if u.meta.nbytes > self.max_upload_bytes:
                    findings.append(self._finding(
                        f"upload {u.meta.dtype}{list(u.meta.shape)} is "
                        f"{u.meta.nbytes} B > per-upload cap "
                        f"{self.max_upload_bytes} B — per-run data belongs "
                        f"on the device before the round loop",
                        path=_path_str(u.path)))
        if total > self.max_total_bytes:
            findings.append(self._finding(
                f"total upload {total} B > cap {self.max_total_bytes} B "
                f"over {len(ups)} upload(s) in the round"))
        return findings


@dataclasses.dataclass(frozen=True)
class DtypeFlow(Rule):
    """No forbidden dtypes anywhere; kernel upcasts only where declared.

    ``forbid`` dtypes (default f64 and c128: one stray ``np.float64``
    doubles every buffer downstream) may not appear on any op's input or
    output, nor on an upload.  The reference also forbids int64; torch
    indexes in int64 (``index``, ``gather``, ``argmax`` all take or give
    it), so the port does not.

    ``expect_kernel_upcasts`` checks the low-precision-aggregation
    contract inside the kernel regions, where on the CPU the plain
    versions run: ``True`` requires at least one bf16/f16 → f32 cast there
    (``mix_in_float32=True`` on a bf16 plane), ``False`` none (the
    ablation stays in the plane's dtype), ``None`` skips.  On the card the
    kernel does its casts in registers, so the check applies to CPU runs
    only.  Expectations come from ``kernels.gossip_mix.mix_accum_upcasts``.
    """

    forbid: Tuple[str, ...] = ("float64", "complex128")
    expect_kernel_upcasts: Optional[bool] = None
    name = "dtype-flow"

    def _kernel_upcasts(self, ctx: AnalysisContext) -> int:
        kernels = frozenset(KERNEL_REGIONS)
        n = 0
        for ev in iter_ops(ctx.events):
            if ev.op not in _COPIES or not any(
                    name in kernels for name, _ in ev.path):
                continue
            if any(m.dtype in _SMALL_FLOATS for m in ev.inputs) and any(
                    m.dtype == torch.float32 for m in ev.outputs):
                n += 1
        return n

    def measure(self, ctx: AnalysisContext) -> Dict[str, object]:
        return {"kernel_upcasts": self._kernel_upcasts(ctx),
                "device": ctx.device_type}

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings, seen = [], set()
        for ev in ctx.events:
            if isinstance(ev, Upload):
                metas = (ev.meta,)
            elif isinstance(ev, RegionEntry):
                continue
            else:
                metas = ev.inputs + ev.outputs
            for m in metas:
                dt = str(m.dtype).replace("torch.", "")
                key = (dt, ev.path)
                if dt in self.forbid and key not in seen:
                    seen.add(key)
                    what = ("upload" if isinstance(ev, Upload)
                            else f"op {ev.target}")
                    findings.append(self._finding(
                        f"forbidden dtype {dt} (shape {list(m.shape)}) in "
                        f"{what}", path=_path_str(ev.path)))
        if self.expect_kernel_upcasts is not None \
                and ctx.device_type == "cpu":
            ups = self._kernel_upcasts(ctx)
            if self.expect_kernel_upcasts and ups == 0:
                findings.append(self._finding(
                    "declared f32 accumulation (mix_in_float32=True) but "
                    "no small-float→f32 cast in any kernel region — the "
                    "accumulation runs in low precision"))
            if not self.expect_kernel_upcasts and ups > 0:
                findings.append(self._finding(
                    f"low-precision path (mix_in_float32=False) casts to "
                    f"f32 at {ups} site(s) inside kernel regions — it must "
                    f"stay in the plane dtype"))
        return findings


def _run_of(args):
    run = args[0] if args else None
    if not (hasattr(run, "params") and hasattr(run, "opt")):
        raise TypeError("Donation needs the engine's step: "
                        "fn(run, a, b) from SweepEngine.traceable")
    return run


@dataclasses.dataclass(frozen=True)
class Donation(Rule):
    """The step releases (or keeps) the carry it was given.

    The chunked and mesh modes must not hold two copies of the model
    state across a chunk boundary (the reference donates the ``(params,
    opt)`` carry; DESIGN.md §8).  ``expect=True``: weak references to the
    carry's leaves (the engine's ``_Run`` ``params`` and ``opt``, ``fn``'s
    first argument) are taken before the step, and after it returns every
    one of the params' leaves must be dead.  ``expect=False`` (the scanned
    mode, which donates nothing): the carry the step was given is
    bit-identical after it — the round loop writes no input in place.
    """

    expect: bool = True
    name = "donation"

    def before(self, fn, args, kwargs) -> Any:
        run = _run_of(args)
        params = tree_util.leaves(run.params)
        leaves = params + tree_util.leaves(run.opt)
        if self.expect:
            return {"refs": [weakref.ref(x) for x in leaves],
                    "n_params": len(params)}
        return {"kept": leaves, "copies": [x.clone() for x in leaves]}

    def measure(self, ctx: AnalysisContext) -> Dict[str, object]:
        state = ctx.before[id(self)]
        if "measured" not in state:
            if self.expect:
                gc.collect()
                state["measured"] = {
                    "released": sum(r() is None for r in state["refs"]),
                    "carry_leaves": len(state["refs"])}
            else:
                same = sum(torch.equal(a, b) or bool(
                    torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a),
                                    torch.nan_to_num(b)))
                    for a, b in zip(state["kept"], state["copies"]))
                state["measured"] = {"unchanged": same,
                                     "carry_leaves": len(state["kept"])}
        return state["measured"]

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        got = self.measure(ctx)
        if self.expect:
            want = ctx.before[id(self)]["n_params"]
            if got["released"] < want:
                return [self._finding(
                    f"expected ≥ {want} carry leaves released after the "
                    f"step, found {got['released']} of "
                    f"{got['carry_leaves']} — the previous carry is kept")]
            return []
        if got["unchanged"] != got["carry_leaves"]:
            return [self._finding(
                f"{got['carry_leaves'] - got['unchanged']} of "
                f"{got['carry_leaves']} input carry leaves changed — the "
                f"step wrote its input in place")]
        return []


@dataclasses.dataclass(frozen=True)
class HostSync(Rule):
    """No host round-trip inside the round.

    Inside the scope: no :data:`SYNC_OPS` (``.item()``/``float()``/
    ``bool()`` of a tensor reach the dispatcher as
    ``_local_scalar_dense``; ``nonzero``, ``masked_select`` and boolean
    indexing have data-dependent shapes), no device-to-host copy, and no
    boolean-mask ``index``.  Each would stall every round on the host
    (the reference's host-callback contract).  On the card
    :func:`analyze` also runs the program under
    ``torch.cuda.set_sync_debug_mode("error")``; a sync it refused is a
    finding.
    """

    forbid: Tuple[str, ...] = SYNC_OPS
    scope: str = "round"
    name = "host-sync"

    def check(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for ev in iter_ops(ctx.scoped(self.scope), exclude_within=()):
            bad = None
            if ev.op in self.forbid:
                bad = f"host sync {ev.target!r}"
            elif ev.op in _COPIES and any(
                    m.device == "cuda" for m in ev.inputs) and any(
                    m.device == "cpu" for m in ev.outputs):
                bad = f"device-to-host copy {ev.target!r}"
            elif ev.op == "index" and any(
                    m.dtype == torch.bool for m in ev.inputs[1:]):
                bad = "boolean-mask index (data-dependent shape)"
            if bad:
                findings.append(self._finding(
                    f"{bad} inside scope {self.scope!r}",
                    path=_path_str(ev.path)))
        if ctx.sync_error is not None:
            findings.append(self._finding(
                f"the card refused a sync: {ctx.sync_error}"))
        return findings


def _device_type(events) -> str:
    for ev in events:
        metas = (ev.meta,) if isinstance(ev, Upload) else \
            getattr(ev, "inputs", ()) + getattr(ev, "outputs", ())
        if any(m.device == "cuda" for m in metas):
            return "cuda"
    return "cpu"


def analyze(fn: Callable, *args, rules: Sequence[Rule],
            name: Optional[str] = None, device=None, **kwargs) -> Report:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpRecorder` and check
    every rule against what it did.  With ``device`` a CUDA device and a
    :class:`HostSync` rule, the run is under
    ``torch.cuda.set_sync_debug_mode("error")``.  ``fn``'s result is
    dropped before the rules look (so a released carry is dead).  Returns
    a :class:`Report`; gate with ``report.raise_if_failed()``."""
    before = {id(rule): rule.before(fn, args, kwargs) for rule in rules}
    on_card = device is not None and torch.device(device).type == "cuda"
    guard = on_card and any(isinstance(r, HostSync) for r in rules)
    sync_error = None
    recorder = OpRecorder()
    with recorder:
        if guard:
            previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args, **kwargs)
        except RuntimeError as e:
            if not (guard and "synchroniz" in str(e)):
                raise
            sync_error = str(e).splitlines()[0]
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode(previous)
    fn_name = name or getattr(fn, "__name__", "<fn>")
    ctx = AnalysisContext(events=recorder.events, name=fn_name,
                          device_type=_device_type(recorder.events),
                          sync_error=sync_error, before=before)
    outcomes = []
    for rule in rules:
        findings = rule.check(ctx)
        measured = rule.measure(ctx) if hasattr(rule, "measure") else {}
        outcomes.append(RuleOutcome(rule=rule.name, findings=findings,
                                    measured=measured))
    return Report(name=fn_name, outcomes=outcomes)
