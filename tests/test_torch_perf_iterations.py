"""The port's perf-iteration planner (``repro_torch.benchmarks.
perf_iterations``) against the reference's (``benchmarks/perf_iterations.py``)
on the CPU.

Both drive the same iterations over their ``analyze_pair``; the port's
terms are the reference's formulas over the H100's datasheet constants.
So every term but the times (and what derives from them) equals the
reference's in every row of pairs A–D, and with the reference's TPU
constants patched into the port's roofline module the whole results dict
is the reference's.  ``--verify`` runs the port's dry-run on the winning
plans; on an 8-core Xeon plan A took 9.1 s, C 9.3 s, D 25.9 s and B
120.5 s alone, so the tests run C's (the others through the CLI), check
the four plans against the reference script's, and check that a plan
the dry-run cannot run is reported and the others go on.
"""
import ast
import contextlib
import io
import json
import types

import pytest

from repro_torch.benchmarks import perf_iterations as tpi
from repro_torch.benchmarks import roofline as trl

PAIRS = ("pair_a", "pair_b", "pair_c", "pair_d")
# derived from the times or the device's memory, not terms
DERIVED = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
           "roofline_frac", "fits_hbm", "modeled"}


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(*args)
    return res, out.getvalue()


def _results(module):
    """Pairs A–D of ``module`` (the port's or the reference's): the
    results dict and the plan each pair returns."""
    results = {}
    plans = [_quiet(getattr(module, name), results)[0] for name in PAIRS]
    return results, plans


def _rows(results):
    for tag, pair in sorted(results.items()):
        for i, row in enumerate([pair["baseline"]] + pair["iters"]):
            yield (tag, i), row


def _terms(row):
    return {k: v for k, v in row.items() if k not in DERIVED}


def test_terms_equal_the_reference():
    """Every row's non-time terms, the plans, and pair B's pick (tp 8,
    micro 4 on both constants) equal the reference's."""
    import benchmarks.perf_iterations as jpi

    got, got_plans = _results(tpi)
    want, want_plans = _results(jpi)
    assert list(got) == list(want) == ["A", "B", "C", "D"]
    got_rows, want_rows = dict(_rows(got)), dict(_rows(want))
    assert list(got_rows) == list(want_rows)
    for key in got_rows:
        assert _terms(got_rows[key]) == _terms(want_rows[key]), key
        assert got_rows[key]["modeled"] is True
    assert got["B"]["best_plan"] == want["B"]["best_plan"]
    assert [vars(p) for p in got_plans] == [vars(p) for p in want_plans]
    for tag in got:
        assert got[tag]["speedup"] == pytest.approx(
            tpi.bound(got[tag]["baseline"])
            / tpi.bound(got[tag]["iters"][-1]), rel=1e-12)


def test_results_are_the_reference_s_on_its_constants(monkeypatch):
    """With the reference's constants (TPU v5e: 197 TFLOP/s, 819 GB/s,
    50 GB/s ICI, 16 GiB) in the port's roofline module, the whole results
    dict, times and speedups included, is the reference's (the port's
    rows carry one more key, ``modeled``)."""
    import benchmarks.perf_iterations as jpi
    import benchmarks.roofline as jrl

    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "HBM_PER_CHIP"):
        monkeypatch.setattr(trl, name, getattr(jrl, name))
    got, _ = _results(tpi)
    want, _ = _results(jpi)
    for _, row in _rows(got):
        assert row.pop("modeled") is True
    assert got == want


def test_main_writes_the_record_and_prints_modeled(tmp_path, monkeypatch):
    """``main`` prints the modeled label and every pair's speedup, and
    writes its record to ``artifacts_torch/perf_iterations.json`` under
    the working directory by default."""
    monkeypatch.chdir(tmp_path)
    res, out = _quiet(tpi.main, [])
    assert out.splitlines()[0].startswith("modeled: H100 SXM5 datasheet")
    for tag in "ABCD":
        assert f"=== Pair {tag}:" in out
    saved = json.loads((tmp_path / "artifacts_torch"
                        / "perf_iterations.json").read_text())
    assert {t: r["speedup"] for t, r in saved.items()} == \
        {t: r["speedup"] for t, r in res.items()}
    assert "verify" not in res


def test_verify_plans_are_the_reference_s():
    """The four plans ``--verify`` runs equal the ``plans`` dict of the
    reference's ``main`` (taken from its source with ``ast``, so the
    script does not run), pair B's from a pick of tp 8, micro 4."""
    import benchmarks.perf_iterations as jpi

    tree = ast.parse(open(jpi.__file__).read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and [getattr(t, "id", None) for t in n.targets] == ["plans"])
    pb = types.SimpleNamespace(tp_degree=8, microbatch=4)
    want = eval(compile(ast.Expression(node.value), jpi.__file__, "eval"),
                {"dict": dict, "pb": pb})
    assert tpi.verify_plans(pb) == want


def test_verify_reports_a_failed_plan_and_goes_on(monkeypatch):
    """A plan whose dry-run raises is printed as FAILED with its
    traceback and recorded as None; the next plan still runs."""
    import repro_torch.launch.dryrun as dryrun

    def fake(arch, shape, multi_pod, pcfg):
        if arch == "gemma2-27b":
            raise RuntimeError("no such plan")
        return {"arch": arch, "shape": shape, "run_s": 0.5,
                "memory": {"peak_per_device": 1e9}, "fits_hbm": True}

    monkeypatch.setattr(dryrun, "dry_run_pair", fake)
    plans = {"A": ("gemma2-27b", "train_4k", {}),
             "C": ("llama4-scout-17b-a16e", "decode_32k", dict(n_nodes=1))}
    res, out = _quiet(tpi.verify, plans)
    assert res["A"] is None and res["C"]["run_s"] == 0.5
    assert "verify A: FAILED" in out and "no such plan" in out
    assert "verify C: RAN in 0.5 s" in out


@pytest.mark.parametrize("tag", ["C"])
def test_verify_runs_the_dry_run_on_the_winning_plan(tag):
    """``--verify``'s step on one plan: ``dry_run_pair`` over the
    production mesh, its record naming the pair and its time as
    ``run_s``.  Pair B's plan is this run's pick (tp 8, micro 4)."""
    plans = tpi.verify_plans(types.SimpleNamespace(tp_degree=8,
                                                   microbatch=4))
    arch, shape, _ = plans[tag]
    res, out = _quiet(tpi.verify, {tag: plans[tag]})
    rec = res[tag]
    assert list(res) == [tag]
    assert rec is not None, out
    assert (rec["arch"], rec["shape"]) == (arch, shape)
    assert rec["run_s"] >= 0 and rec["memory"]["peak_per_device"] > 0
    assert f"verify {tag}: RAN in {rec['run_s']} s" in out
