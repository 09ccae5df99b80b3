"""The port's sweep CLI (``repro_torch.benchmarks.sweep``) against the
reference's (``benchmarks/sweep.py``) on the CPU.

Host side, for every preset: the cells, the ``plan()`` text at the smoke,
QUICK and FULL scales, ``--list``, ``--dry-run`` and the verdict lines on
fixed rows equal the reference's exactly.  One end-to-end run:
``--preset fig4 --smoke`` on the CPU gives the rows of
``run_sweep_cells`` on the same cells and the reference's record keys,
and the legacy baseline (each cell alone through the engine's unrolled
mode) holds to the grid.  ``--shard`` under gloo at worlds 2 and 4
(ranks spawned): rows equal to the unsharded run's, the reference's
``sharded/<preset>`` record keys, ``--shard-scale``'s crossover record;
its refusals, and the default device without a GPU, raise.  The
benchmark runner (``repro_torch.benchmarks.run``) takes
the reference's sections, ``roofline`` included.
"""
import io
import json
import contextlib

import numpy as np
import pytest
import torch

import benchmarks.common as jc
import benchmarks.sweep as jsweep
from repro_torch.benchmarks import common as tc
from repro_torch.benchmarks import sweep as tsweep

torch.set_num_threads(2)

PRESETS = sorted(jsweep.PRESETS)


def _cell_key(c):
    return (c.dataset, c.strategy, c.ood_k, c.tau, c.seed, c.name, c.sweep,
            c.p_fail, c.reactive, c.ood_ks, c.participation, c.fault_rate,
            c.robust, c.topo.name, c.topo.adjacency.tobytes(),
            c.ood_nodes())


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_registry_equals_the_reference():
    """The nine presets with the reference's names, descriptions, default
    datasets and seeds, programs flag, backend and fault kwargs; a taken
    name raises; ``--list`` prints the same lines."""
    assert sorted(tsweep.PRESETS) == PRESETS and len(PRESETS) == 9
    for name in PRESETS:
        a, b = tsweep.PRESETS[name], jsweep.PRESETS[name]
        for f in ("description", "datasets", "seeds", "programs", "mix_impl",
                  "fault_kwargs"):
            assert getattr(a, f) == getattr(b, f), (name, f)
    with pytest.raises(KeyError, match="already registered"):
        tsweep.register_preset(tsweep.PRESETS["fig4"])
    assert (_stdout(tsweep.main, ["--list"])
            == _stdout(jsweep.main, ["--list"]))
    assert _stdout(tsweep.main, []) == _stdout(jsweep.main, [])


@pytest.mark.parametrize("name", PRESETS)
def test_preset_cells_plan_and_dry_run_equal_the_reference(name):
    """Each preset's cells at n = 16 and 33 (the CLI's QUICK and FULL node
    counts), its plan at the smoke, QUICK and FULL scales and its
    ``--dry-run`` output, equal to the reference's exactly."""
    a, b = tsweep.PRESETS[name], jsweep.PRESETS[name]
    for n in (16, 33):
        ca = a.build(a.datasets, a.seeds, n)
        cb = b.build(b.datasets, b.seeds, n)
        assert [_cell_key(c) for c in ca] == [_cell_key(c) for c in cb]
    smoke = jc.BenchScale(n_train=1500, n_test=300, rounds=6, local_epochs=2,
                          batch=16, steps_per_epoch=4, eval_every=2,
                          eval_n=128)
    assert tsweep.SMOKE == tc.BenchScale(**smoke.__dict__)
    for tscale, jscale in ((tsweep.SMOKE, smoke), (tc.QUICK, jc.QUICK),
                           (tc.FULL, jc.FULL)):
        assert tsweep.plan(ca, tscale) == jsweep.plan(cb, jscale)
    for flags in ([], ["--full"], ["--smoke"]):
        argv = ["--preset", name, "--dry-run"] + flags
        assert _stdout(tsweep.main, argv) == _stdout(jsweep.main, argv)


def _fixed_rows(cells):
    """Deterministic summary rows for a preset's cells, with every key a
    verdict reads."""
    rng = np.random.default_rng(len(cells))
    rows = []
    for i, c in enumerate(cells):
        iid, ood, fin, act, stale, arr = rng.uniform(0, 1, 6)
        rows.append({
            "dataset": c.dataset, "strategy": c.strategy, "seed": c.seed,
            "ood_k": c.ood_k, "iid_auc": float(iid), "ood_auc": float(ood),
            "sweep": c.sweep, "p_fail": c.p_fail,
            "final_ood_acc_mean": float(fin),
            "analytics": {"ood_arrival_mean": (None if i % 3 == 0
                                               else float(10 * arr))},
            "participation_rate": (1.0 if c.participation is None
                                   else c.participation),
            "participation": {"activity_rate": float(act),
                              "mean_staleness": (0.0 if c.participation
                                                 in (None, 1.0)
                                                 else float(stale))},
            "fault_rate": 0.0 if c.fault_rate is None else c.fault_rate,
            "robust": c.robust,
        })
    return rows


@pytest.mark.parametrize("name", PRESETS)
def test_preset_verdicts_equal_the_reference(name):
    """Each preset's verdict line on the same fixed rows, as the
    reference's, character for character."""
    cells = jsweep.PRESETS[name].build(("mnist",), (0, 1), 16)
    rows = _fixed_rows(cells)
    assert (tsweep.PRESETS[name].verdict(rows)
            == jsweep.PRESETS[name].verdict(rows))


# the reference's record keys (benchmarks/sweep.py main: the analytics
# section) and its row keys for a fig4 grid
ANALYTICS_KEYS = {"preset", "experiments", "rounds", "n_nodes",
                  "arrival_threshold", "max_stream_vs_host_dev",
                  "mean_ood_arrival_round", "rows_with_arrival",
                  "history_metric_bytes", "streaming_summary_bytes",
                  "bytes_ratio"}
ROW_KEYS = {"analytics", "dataset", "final_ood_acc_by_hop",
            "final_ood_acc_mean", "iid_auc", "iid_ood_gap_pct",
            "ood_arrival_by_hop", "ood_arrival_mean", "ood_auc", "ood_k",
            "ood_node", "ood_sources", "secs", "seed", "strategy",
            "sweep_group_size", "sweep_secs", "topology"}
# Measured: the legacy baseline (each cell alone, E = 1, unrolled) and
# the E = 6 grid give the same AUCs bit for bit on the CPU (0.0 apart).
# Pinned at 1e-6, the engine tests' accuracy pin.
LEGACY_DRIFT = 1e-6


def _same(a, b):
    """Rows equal but for their wall-clock fields."""
    skip = {"secs", "sweep_secs"}
    assert set(a) == set(b)
    for k in set(a) - skip:
        assert json.dumps(a[k], sort_keys=True, default=str) == json.dumps(
            b[k], sort_keys=True, default=str), k


def test_fig4_smoke_run_end_to_end(tmp_path, capsys):
    """``--preset fig4 --smoke --seeds 0 --datasets mnist --device cpu``:
    its rows equal ``run_sweep_cells`` on the preset's cells; the records
    (``BENCH_sweep.json``, the analytics mirror, ``sweep_fig4.json``)
    carry the reference's keys; its legacy-baseline lines are logged, and
    the baseline's rows hold to the grid's within ``LEGACY_DRIFT``."""
    argv = ["--preset", "fig4", "--smoke", "--seeds", "0", "--datasets",
            "mnist", "--device", "cpu", "--out", str(tmp_path)]
    rows = tsweep.main(argv)
    out = capsys.readouterr().out
    cells = tsweep.PRESETS["fig4"].build(("mnist",), (0,), 16)
    direct = tc.run_sweep_cells(cells, scale=tsweep.SMOKE, device="cpu")
    assert len(rows) == len(direct) == 6
    for a, b in zip(rows, direct):
        _same(a, b)
        assert set(a) == ROW_KEYS
    bench = json.loads((tmp_path / "BENCH_sweep.json").read_text())
    assert set(bench) == {"analytics/fig4"}
    assert set(bench["analytics/fig4"]) == ANALYTICS_KEYS
    assert json.loads((tmp_path / "BENCH_sweep_analytics.json").read_text()
                      ) == bench
    saved = json.loads((tmp_path / "sweep_fig4.json").read_text())
    assert [r["ood_auc"] for r in saved] == [r["ood_auc"] for r in rows]
    assert out.count("  legacy fig4/mnist/ba_p2/") == 6
    assert "speedup:" in out and "=== verdict ===" in out
    legacy = tsweep.run_legacy_baseline(cells, tsweep.SMOKE,
                                        log=lambda *a: None, device="cpu")
    for a, b in zip(legacy, direct):
        for k in ("iid_auc", "ood_auc", "final_ood_acc_mean"):
            assert abs(a[k] - b[k]) <= LEGACY_DRIFT, (a["strategy"], k)


def test_shard_and_the_default_device_raise(monkeypatch):
    """``--shard 4`` in a world of 1 raises naming ``--nproc-per-node``;
    ``--shard`` with ``--unroll`` and ``--shard-scale`` without
    ``--shard`` exit as the reference's do; without a GPU the default
    device raises."""
    import torch.distributed as dist

    argv = ["--preset", "fig4", "--smoke", "--device", "cpu"]
    try:
        with pytest.raises(ValueError, match="--nproc-per-node 4"):
            tsweep.main(argv + ["--shard", "4"])
    finally:
        dist.destroy_process_group()
    with pytest.raises(SystemExit, match="--shard cannot combine with "
                                         "--unroll"):
        tsweep.main(argv + ["--shard", "--unroll"])
    with pytest.raises(SystemExit, match="--shard-scale requires --shard"):
        tsweep.main(argv + ["--shard-scale", "2,4"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.main(["--preset", "fig4", "--smoke", "--no-legacy",
                     "--seeds", "0"])


def test_benchmark_runner_sections(tmp_path, capsys):
    """``python -m repro_torch.benchmarks.run``: its sections are the
    reference's, ``roofline`` the H100 table (modeled;
    ``tests/test_torch_roofline.py`` holds its terms to the reference's);
    ``--only serve,mix --device cpu`` prints the CSV header, writes the
    sections' records and the reference's two verdict lines."""
    from repro_torch.benchmarks import run as trun

    assert trun.SECTIONS == ("fig2", "fig4", "fig5", "fig6", "ablations",
                             "gossip", "mix", "serve", "roofline")
    assert trun.main(["--only", "roofline", "--device", "cpu",
                      "--out", str(tmp_path)]) == []
    assert "modeled: H100 SXM5 datasheet" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        trun.main(["--only", "fig9", "--device", "cpu"])
    verdicts = trun.main(["--only", "serve,mix", "--device", "cpu",
                          "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived\n")
    assert len(verdicts) == 2
    assert verdicts[0].startswith("mix kernel: fused plane ")
    assert verdicts[1].startswith("serving: fleet-vmapped continuous "
                                  "batching ")
    assert "outputs identical and post-gossip swap in place: True" in \
        verdicts[1]
    assert {p.name for p in tmp_path.iterdir()} >= {"BENCH_mix.json",
                                                    "BENCH_serve.json",
                                                    "roofline_1pod.json"}
