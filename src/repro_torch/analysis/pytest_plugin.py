"""The ``torchlint`` pytest fixture — the analyzer as a test utility (port
of ``repro/analysis/pytest_plugin.py``).

The repository's root ``conftest.py`` is the reference's, so a test module
imports the fixture itself::

    from repro_torch.analysis.pytest_plugin import torchlint  # noqa: F401

    def test_fused(torchlint):
        assert torchlint.kernel_calls(fn, *args) == 1

    def test_budget(torchlint):
        rule = torchlint.FusionBudget.of({"gossip_plane": 1}, scope="all")
        torchlint.check(fn, *args, rules=[rule])
"""
from __future__ import annotations

from typing import Optional, Sequence

import pytest

from repro_torch.analysis.report import Report
from repro_torch.analysis.rules import (
    ConstantFootprint,
    Donation,
    DtypeFlow,
    FusionBudget,
    HostSync,
    analyze,
)
from repro_torch.analysis.walker import (
    KERNEL_REGIONS,
    OpRecorder,
    count_calls,
    count_ops,
)


class Torchlint:
    """Thin handle over :mod:`repro_torch.analysis` for test suites."""

    FusionBudget = FusionBudget
    ConstantFootprint = ConstantFootprint
    DtypeFlow = DtypeFlow
    Donation = Donation
    HostSync = HostSync
    analyze = staticmethod(analyze)

    def record(self, fn, *args, **kwargs) -> list:
        """The events of one run of ``fn(*args, **kwargs)``."""
        with OpRecorder() as rec:
            fn(*args, **kwargs)
        return rec.events

    def count(self, fn, *args, names: Optional[Sequence[str]] = None,
              exclude_within: Sequence[str] = KERNEL_REGIONS, **kwargs):
        """aten ops by name in one run (kernel regions excluded by
        default)."""
        return count_ops(self.record(fn, *args, **kwargs), names=names,
                         exclude_within=exclude_within)

    def kernel_calls(self, fn, *args, **kwargs) -> int:
        """Kernel-wrapper calls in one run (the reference's
        ``pallas_calls``)."""
        return sum(count_calls(self.record(fn, *args, **kwargs)).values())

    def check(self, fn, *args, rules, name=None, **kwargs) -> Report:
        """:func:`analyze` + raise on any finding."""
        return analyze(fn, *args, rules=rules, name=name,
                       **kwargs).raise_if_failed()


@pytest.fixture(scope="session")
def torchlint() -> Torchlint:
    return Torchlint()
