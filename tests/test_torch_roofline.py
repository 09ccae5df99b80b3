"""The port's analytic roofline (``repro_torch.benchmarks.roofline``)
against the reference's ``benchmarks/roofline.py``, on the CPU.

The byte, FLOP and collective formulas are the reference's, so every term
but the times (and what is derived from them: the dominant term, the
compute fraction, the fit verdict against another device's memory) must
equal the reference's exactly, for every (arch × shape) pair and both
meshes, both gossip schedules; the times are the same terms over the
H100's datasheet constants.  ``python -m repro_torch.benchmarks.run
--only roofline`` prints the H100 table, labelled modeled.
"""
import json

import pytest

from repro_torch.benchmarks import roofline as trl
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES

PAIRS = [(arch, name) for arch in sorted(registry.ARCHS) for name in SHAPES
         if not (name == "long_500k" and arch in trl.LONG_CTX_SKIP)]
# derived from the times or the device's memory, not terms
DERIVED = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
           "roofline_frac", "fits_hbm", "modeled"}


def test_constants_are_the_h100_datasheet():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.NVLINK_BW, trl.IB_BW,
            trl.HBM_PER_CHIP) == (989e12, 3.35e12, 450e9, 50e9, 80 * 10**9)
    assert trl.ICI_BW == trl.IB_BW
    assert len(PAIRS) == 34


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_terms_equal_the_reference(arch, shape):
    import benchmarks.roofline as jrl
    import repro.configs.registry as jreg

    cfg, pcfg = registry.get_config(arch), registry.get_parallel(arch)
    jcfg, jpcfg = jreg.get_config(arch), jreg.get_parallel(arch)
    sh, jsh = SHAPES[shape], __import__(
        "repro.configs.base", fromlist=["SHAPES"]).SHAPES[shape]
    for multi_pod in (False, True):
        plan = trl.resolve_plan(cfg, pcfg, sh, multi_pod)
        jplan = jrl.resolve_plan(jcfg, jpcfg, jsh, multi_pod)
        assert vars(plan) == vars(jplan) and plan.chips == jplan.chips
        assert trl.step_flops(cfg, sh, plan) == jrl.step_flops(jcfg, jsh,
                                                               jplan)
        assert trl.step_hbm_bytes(cfg, pcfg, sh, plan) == \
            jrl.step_hbm_bytes(jcfg, jpcfg, jsh, jplan)
        assert trl.cache_bytes(cfg, sh, plan) == jrl.cache_bytes(jcfg, jsh,
                                                                 jplan)
        for sched in ("dense", "sparse"):
            assert trl.step_collective_bytes(cfg, pcfg, sh, plan, sched) == \
                jrl.step_collective_bytes(jcfg, jpcfg, jsh, jplan, sched)
        got, want = (trl.hbm_resident_bytes(cfg, pcfg, sh, plan),
                     jrl.hbm_resident_bytes(jcfg, jpcfg, jsh, jplan))
        assert got["per_chip"] == want["per_chip"]
        assert got["fits"] == (got["per_chip"] < 0.9 * 80e9)
        row, jrow = (trl.analyze_pair(arch, shape, multi_pod),
                     jrl.analyze_pair(arch, shape, multi_pod))
        assert {k: v for k, v in row.items() if k not in DERIVED} == \
            {k: v for k, v in jrow.items() if k not in DERIVED}
        fl = trl.step_flops(cfg, sh, plan)["per_chip"]
        assert row["t_compute_s"] == fl / 989e12
        assert row["t_memory_s"] == trl.step_hbm_bytes(
            cfg, pcfg, sh, plan)["per_chip"] / 3.35e12
        assert row["t_collective_s"] == trl.step_collective_bytes(
            cfg, pcfg, sh, plan, pcfg.gossip_schedule)["per_chip"] / 50e9


def test_full_table_and_runner_print_the_h100_table(tmp_path, capsys):
    from repro_torch.benchmarks import run as trun

    rows = trl.full_table()
    assert len(rows) == 40   # 10 archs × 4 shapes, 6 skips recorded
    assert sum("skipped" in r for r in rows) == 6
    table = trl.format_table(rows)
    assert table.splitlines()[0].startswith("modeled: H100 SXM5 datasheet")
    verdicts = trun.main(["--only", "roofline", "--device", "cpu", "--out",
                          str(tmp_path)])
    out = capsys.readouterr().out
    assert verdicts == [] and table in out
    saved = json.loads((tmp_path / "roofline_1pod.json").read_text())
    assert [r["arch"] for r in saved] == [r["arch"] for r in rows]
    assert trl.main(["--multipod", "--out", str(tmp_path)])[0]["mesh"] == \
        "2x16x16"
