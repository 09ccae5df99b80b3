"""Run-time checks of the engine's contracts (port of ``repro/analysis``).

The reference checks trace-time contracts on jaxprs: one fused kernel per
mix, no ``(R, n, n)`` slab folded into the round scan, donated carries in
the chunked and sharded modes, no f64, no host callbacks in the scan
body.  The port checks the same contracts, by the same rule names, on
what an eager PyTorch program does: :class:`walker.OpRecorder` records
every aten op of a run with the regions it ran in (kernel wrappers,
rounds, the mix), every kernel call and every upload, and the rules of
:mod:`~repro_torch.analysis.rules` read that record.

Three entry points:

* **library** — :func:`analyze(fn, *args, rules=...) <analyze>` returns a
  :class:`Report` with per-rule findings;
* **pytest** — the ``torchlint`` fixture
  (``repro_torch.analysis.pytest_plugin``; a test module imports it);
* **CLI** — ``python -m repro_torch.analysis --preset engine-matrix``
  runs one step of every (mode × mix_impl × coefficient kind) combo,
  writes ``artifacts_torch/ANALYSIS.json`` and exits 1 on any finding.
"""
from repro_torch.analysis.report import (AnalysisError, Finding, Report,
                                         RuleOutcome)
from repro_torch.analysis.rules import (
    ConstantFootprint,
    Donation,
    DtypeFlow,
    FusionBudget,
    HostSync,
    Rule,
    analyze,
)
from repro_torch.analysis.walker import (
    OpRecorder,
    count_calls,
    count_ops,
    iter_ops,
    region,
    round_scope,
)

__all__ = [
    "AnalysisError",
    "Finding",
    "Report",
    "RuleOutcome",
    "Rule",
    "FusionBudget",
    "ConstantFootprint",
    "DtypeFlow",
    "Donation",
    "HostSync",
    "analyze",
    "OpRecorder",
    "region",
    "iter_ops",
    "count_ops",
    "count_calls",
    "round_scope",
]
