"""Findings, per-rule outcomes, and the aggregate analysis report (port of
``repro/analysis/report.py``, plain Python)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["Finding", "RuleOutcome", "Report", "AnalysisError"]


class AnalysisError(AssertionError):
    """Raised by :meth:`Report.raise_if_failed` — an ``AssertionError``
    subclass so pytest renders the full report on failure."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation of one rule.

    ``rule``: the rule's registered name (e.g. ``"fusion-budget"``);
    ``message``: human-readable description of what was found where;
    ``path``: where in the run (``/``-joined enclosing regions, e.g.
    ``round/mix``), empty when the finding is program-global.
    """

    rule: str
    message: str
    path: str = ""

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f" [at {self.path}]" if self.path else ""
        return f"{self.rule}: {self.message}{loc}"


@dataclasses.dataclass
class RuleOutcome:
    """One rule's verdict on one program: its findings plus the measured
    quantities the rule based them on (counts, byte totals, donated-buffer
    tallies — whatever the rule reports), so a clean run still documents
    what was checked."""

    rule: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    measured: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "measured": dict(self.measured),
        }


@dataclasses.dataclass
class Report:
    """All rule outcomes for one analyzed program."""

    name: str
    outcomes: List[RuleOutcome] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(o.ok for o in self.outcomes)

    @property
    def findings(self) -> List[Finding]:
        return [f for o in self.outcomes for f in o.findings]

    def outcome(self, rule: str) -> Optional[RuleOutcome]:
        for o in self.outcomes:
            if o.rule == rule:
                return o
        return None

    def failed_rules(self) -> List[str]:
        return [o.rule for o in self.outcomes if not o.ok]

    def raise_if_failed(self) -> "Report":
        if not self.ok:
            raise AnalysisError(str(self))
        return self

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "ok": self.ok,
            "rules": {o.rule: o.to_dict() for o in self.outcomes},
        }

    def __str__(self) -> str:
        lines = [f"analysis report for {self.name}: "
                 f"{'OK' if self.ok else 'FAILED'}"]
        for o in self.outcomes:
            status = "ok" if o.ok else f"{len(o.findings)} finding(s)"
            lines.append(f"  {o.rule}: {status}  {o.measured or ''}".rstrip())
            for f in o.findings:
                lines.append(f"    - {f}")
        return "\n".join(lines)
