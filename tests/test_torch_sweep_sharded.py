"""The port's sharded sweep engine (``SweepEngine.run(mesh=...)``) on the
CPU over gloo: the reference's ``tests/test_sweep_sharded.py`` claims, at
worlds 2 and 4.

Ranks are spawned with ``torch.multiprocessing.spawn`` around a
``FileStore`` under ``tmp_path``, one thread each.  Every rank builds the
same grid from the same seeds (E = 3 experiments, padded to 4: ring(4),
``unweighted``, ``random`` and a ``degree`` link-failure schedule) and
runs it sharded; the test process runs it unsharded and scanned.  Each
sharded result must equal the unsharded one bit for bit — history,
params, every digest — on every rank:

* ``einsum`` and ``pallas`` stacks, sharded and sharded + chunked;
* in-scan coefficient programs with a reactive link-failure cell;
* analytics, partial participation and noise faults with the quarantine
  screen, sharded + chunked, and ``keep_history=False``;
* a checkpointed sharded run killed after its first chunk
  (``REPRO_SWEEP_CRASH_AFTER_CHUNKS``): world 2's checkpoint resumed at
  world 4, world 4's by the unsharded engine;
* the sweep CLI's ``--shard`` at worlds 2 and 4 (six fig4 cells, padded
  to 8 at world 4): rows equal to the unsharded grid's, the reference's
  ``sharded/<preset>`` record keys, ``--shard-scale``'s crossover record;
  at world 4 also bare ``--shard`` (3 ranks) and ``--shard 2``, whose
  ranks outside the mesh run nothing.

One spawn a world runs every sharded case (world 4's after world 2's,
whose checkpoint it resumes).

``pad_experiments`` is held to the reference's.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import tree as tree_util
from repro_torch.core.analytics import AnalyticsSpec
from repro_torch.core.coeffs import ProgramCoeffs, program_for, stack_states
from repro_torch.core.decentralized import (
    DecentralizedConfig,
    coeffs_stack,
    stack_params,
)
from repro_torch.core.dynamic import (
    FaultSpec,
    ParticipationSpec,
    link_failure_schedule,
)
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.sweep import CRASH_ENV, SweepEngine, pad_experiments
from repro_torch.core.topology import ring
from repro_torch.data.backdoor import backdoored_testset
from repro_torch.data.distribution import node_datasets
from repro_torch.data.pipeline import NodeBatcher, make_test_batch
from repro_torch.data.synthetic import make_dataset
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.models.paper_models import (
    classifier_accuracy,
    classifier_loss,
    ffn_apply,
    ffn_init,
)
from repro_torch.training.optimizer import sgd

torch.set_num_threads(2)

N, ROUNDS, BATCH = 4, 4, 8
KINDS = ("unweighted", "random", "degree")      # E = 3


def grid():
    """The reference test's grid, from the port's data layer."""
    cfg = DecentralizedConfig(rounds=ROUNDS, local_epochs=2, eval_every=2)
    train = make_dataset("mnist", 400, seed=0)
    test = make_dataset("mnist", 100, seed=9)
    topo = ring(N)
    parts = node_datasets(train, N, ood_node=0, q=0.10, seed=0)
    nb = NodeBatcher(parts, batch_size=BATCH, steps_per_epoch=2, seed=0,
                     local_epochs=2)
    tb = make_test_batch(test, 32, seed=0)
    ob = make_test_batch(backdoored_testset(test, seed=0), 32, seed=0)
    bank = {k: v[None] for k, v in nb.sample_bank().items()}
    indices = nb.all_round_indices(ROUNDS)[None]
    coeffs = np.stack([
        coeffs_stack(topo, AggregationStrategy(k, seed=0), ROUNDS,
                     nb.data_counts()) for k in KINDS])
    # experiment 2 runs a link-failure schedule
    coeffs[2] = link_failure_schedule(
        topo, AggregationStrategy("degree", tau=0.1, seed=1), ROUNDS,
        p_fail=0.5)
    one = ffn_init(torch.Generator().manual_seed(0))
    params0 = stack_params([stack_params([one] * N)] * len(KINDS))
    st = lambda t: {k: np.stack([np.asarray(t[k])] * len(KINDS)) for k in t}
    ps = [program_for(topo, AggregationStrategy(k, tau=0.1, seed=e),
                      data_counts=nb.data_counts(), p_fail=pf, reactive=True)
          for e, (k, pf) in enumerate(
              [("unweighted", 0.0), ("random", 0.0), ("degree", 0.5)])]
    programs = ProgramCoeffs(ps[0][0], stack_states([s for _, s in ps]))
    inputs = (params0, coeffs, bank, indices, np.zeros(len(KINDS), np.int32),
              st(tb), st(ob))
    return cfg, inputs, programs


def _engine(cfg, **kw):
    return SweepEngine(sgd(1e-2), classifier_loss(ffn_apply),
                       classifier_accuracy(ffn_apply),
                       dataclasses.replace(cfg, **kw), device="cpu")


def _full_kwargs():
    """Analytics, participation and faults together."""
    return dict(analytics=AnalyticsSpec(0.5),
                participation=ParticipationSpec(seed=1),
                participation_rates=np.array([1.0, 0.8, 0.6]),
                fault=FaultSpec(mode="noise", quarantine=True, seed=4),
                fault_rates=np.array([0.0, 0.2, 0.3]))


def cases(cfg, inputs, programs):
    """``name -> (engine, coeffs, run kwargs)``; each name's sharded runs
    are held to the unsharded scanned run of the same engine and coeffs
    (the ``.../chunk`` and ``.../nohist`` names add their options)."""
    return {
        "einsum": (_engine(cfg), inputs[1], {}),
        "pallas": (_engine(cfg, mix_impl="pallas"), inputs[1], {}),
        "programs": (_engine(cfg), programs, {}),
        "full": (_engine(cfg), inputs[1], _full_kwargs()),
    }


SHARDED = {"einsum": ({}, {"chunk_rounds": 3}),
           "pallas": ({}, {"chunk_rounds": 3}),
           "programs": ({}, {"chunk_rounds": 3}),
           "full": ({"chunk_rounds": 2}, {"keep_history": False})}


def _run(engine, inputs, coeffs, **kw):
    p0, _, bank, idx, didx, ti, to = inputs
    return engine.run(p0, coeffs, bank, idx, didx, ti, to, batch_size=BATCH,
                      **kw)


CLI_ARGV = ["--preset", "fig4", "--smoke", "--seeds", "0", "--datasets",
            "mnist", "--device", "cpu", "--no-legacy"]
# the reference's record keys (benchmarks/sweep.py: the sharded-vs-single
# record and --shard-scale's)
SHARDED_KEYS = {"preset", "experiments", "rounds", "n_nodes", "devices",
                "chunk_rounds", "sharded_secs", "single_device_secs",
                "speedup", "bit_identical_metrics"}
SCALE_KEYS = {"preset", "experiments", "n_nodes", "devices", "physical_cpus",
              "chunk_rounds", "scale_sweep", "sharded_fixed_secs",
              "sharded_secs_per_round", "single_fixed_secs",
              "single_secs_per_round", "crossover_rounds", "crossover_kind"}


# at world 4: ``--shard`` with no N takes 3 ranks for 6 cells (2 a rank,
# the least; 3 ranks, the fewest at it), ``--shard 2`` takes 2
FEWER = {"auto": ["--shard"], "two": ["--shard", "2"]}


def _worker(rank, world, store, out, resume_from, crash_to):
    """One rank of a gloo world: every case's sharded modes; the sweep CLI
    at ``--shard <world>`` (and at world 2 ``--shard-scale 1,2``, at world
    4 on :data:`FEWER`'s meshes, which leave ranks idle); the
    full case resumed from ``resume_from``'s checkpoint, if given; then
    the full case checkpointed into ``crash_to`` and killed after its
    first chunk, after saving the rest."""
    import contextlib
    import io

    from repro_torch.benchmarks import sweep as tsweep

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = make_sweep_mesh()
    cfg, inputs, programs = grid()
    got = {}
    for name, (engine, coeffs, kw) in cases(cfg, inputs, programs).items():
        for extra in SHARDED[name]:
            got[(name, tuple(sorted(extra)))] = _run(
                engine, inputs, coeffs, mesh=mesh, **kw, **extra)
    cli = os.path.join(out, "cli")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        got["cli_rows"] = tsweep.main(CLI_ARGV + ["--shard", str(world),
                                                  "--out", cli])
        if world == 2:
            tsweep.main(CLI_ARGV + ["--shard", "2", "--shard-scale", "1,2",
                                    "--out", cli + "_scale"])
    got["cli_stdout"] = text.getvalue()
    if world == 4:   # meshes on fewer ranks than the world
        for name, shard in FEWER.items():
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                got[f"cli_{name}_rows"] = tsweep.main(
                    CLI_ARGV + shard + ["--out", f"{cli}_{name}"])
            got[f"cli_{name}_stdout"] = text.getvalue()
    engine, coeffs, kw = cases(cfg, inputs, programs)["full"]
    if resume_from:
        got["resumed"] = _run(engine, inputs, coeffs, mesh=mesh,
                              chunk_rounds=2, checkpoint_dir=resume_from,
                              resume=True, **kw)
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    os.environ[CRASH_ENV] = "1"
    _run(engine, inputs, coeffs, mesh=mesh, chunk_rounds=2,
         checkpoint_dir=crash_to, **kw)


def assert_same(a, b):
    """Two results bit for bit: history, params, optimizer state, every
    digest."""
    for k in ("train_loss", "iid_acc", "ood_acc"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape and np.array_equal(x, y, equal_nan=True), k
    for name in ("params", "opt_state"):
        xs = tree_util.leaves(getattr(a, name))
        ys = tree_util.leaves(getattr(b, name))
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            assert x.shape == y.shape and torch.equal(x, y), name
    for name in ("analytics", "participation", "fault"):
        da, db = getattr(a, name), getattr(b, name)
        assert (da is None) == (db is None), name
        for k in da or {}:
            assert np.array_equal(da[k], db[k], equal_nan=True), (name, k)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """World 2, then world 4 resuming world 2's checkpoint: ``{world:
    (each rank's results, the CLI's out dir, the crash checkpoint dir,
    the exit code)}``."""
    tmp = tmp_path_factory.mktemp("sharded")
    out, prev = {}, None
    for world in (2, 4):
        d = tmp / f"w{world}"
        d.mkdir()
        ck = str(d / "ck")
        with pytest.raises(mp.ProcessExitedException) as info:
            mp.spawn(_worker, args=(world, str(d / "store"), str(d), prev,
                                    ck), nprocs=world, join=True)
        out[world] = ([torch.load(d / f"rank{r}.pt", weights_only=False)
                       for r in range(world)], d, ck, info.value.exit_code)
        prev = ck
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded scanned run of each case."""
    cfg, inputs, programs = grid()
    out = {}
    for name, (engine, coeffs, kw) in cases(cfg, inputs, programs).items():
        out[name] = _run(engine, inputs, coeffs, **kw)
    engine, coeffs, kw = cases(cfg, inputs, programs)["full"]
    out["nohist"] = _run(engine, inputs, coeffs, keep_history=False, **kw)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_runs_equal_the_unsharded_run(sharded, unsharded, world):
    """E = 3 over 2 ranks (padded to 4) and over 4 ranks (padded to 4):
    every mode of every case, on every rank, bit for bit the unsharded
    scanned run."""
    for got in sharded[world][0]:
        modes = {k: v for k, v in got.items() if isinstance(k, tuple)}
        assert len(modes) == 8
        for (name, extra), res in modes.items():
            want = unsharded["nohist" if extra == ("keep_history",)
                             else name]
            assert res.train_loss.shape[0] == len(KINDS)
            assert_same(res, want)
        nohist = modes[("full", ("keep_history",))]
        assert nohist.train_loss.shape == (len(KINDS), 0, N)
        for k in unsharded["full"].analytics:
            assert np.array_equal(nohist.analytics[k],
                                  unsharded["full"].analytics[k]), k


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_checkpoint_kill_and_resume(sharded, unsharded, world):
    """A sharded run with a checkpoint at each 2-round boundary, killed
    after the first (every rank ends with code 17, no cleanup), leaves one
    checkpoint in the unsharded format (E = 3, no padding): world 2's
    resumes at world 4, bit for bit the uninterrupted run, and world 4's
    resumes in the unsharded engine."""
    _, _, ck, code = sharded[world]
    assert code == 17
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.npz"]
    want = unsharded["full"]
    if world == 2:
        for got in sharded[4][0]:
            assert_same(got["resumed"], want)
    else:
        cfg, inputs, programs = grid()
        engine, coeffs, kw = cases(cfg, inputs, programs)["full"]
        assert_same(_run(engine, inputs, coeffs, chunk_rounds=2,
                         checkpoint_dir=ck, resume=True, **kw), want)


@pytest.fixture(scope="module")
def cli_unsharded():
    """The CLI's cells through ``run_sweep_cells``, unsharded."""
    from repro_torch.benchmarks import common as tc
    from repro_torch.benchmarks import sweep as tsweep

    cells = tsweep.PRESETS["fig4"].build(("mnist",), (0,), 16)
    return tc.run_sweep_cells(cells, scale=tsweep.SMOKE, device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_cli_rows_and_records(sharded, cli_unsharded, world):
    """``--preset fig4 --smoke --seeds 0 --datasets mnist --shard <world>
    --device cpu``: six cells, three a rank at world 2 and padded to 8 at
    world 4; every rank's rows equal the unsharded grid's; only rank 0
    prints and writes; the ``sharded/fig4`` record carries the
    reference's keys, its metrics bit-identical; at world 2
    ``--shard-scale 1,2`` writes the crossover record."""
    ranks, d, _, _ = sharded[world]
    skip = {"secs", "sweep_secs"}
    for r, got in enumerate(ranks):
        assert len(got["cli_rows"]) == 6
        for a, b in zip(got["cli_rows"], cli_unsharded):
            assert set(a) == set(b)
            for k in set(a) - skip:
                assert json.dumps(a[k], sort_keys=True, default=str) == \
                    json.dumps(b[k], sort_keys=True, default=str), k
        assert (got["cli_stdout"] == "") == (r > 0)
    pad = {2: 0, 4: 2}[world]
    assert (f"sharding the experiment axis over {world} rank(s) (E=6, "
            f"padding {pad}); chunk_rounds=None") in ranks[0]["cli_stdout"]
    bench = json.loads((d / "cli" / "BENCH_sweep.json").read_text())
    assert set(bench) == {"analytics/fig4", "sharded/fig4"}
    rec = bench["sharded/fig4"]
    assert set(rec) == SHARDED_KEYS
    assert rec["devices"] == world and rec["bit_identical_metrics"] is True
    if world == 2:
        scale = json.loads((d / "cli_scale" / "BENCH_sweep.json")
                           .read_text())["sharded/fig4"]
        assert set(scale) == SCALE_KEYS
        assert [e["rounds"] for e in scale["scale_sweep"]] == [1, 2]
        assert all(e["bit_identical_metrics"] for e in scale["scale_sweep"])


@pytest.mark.parametrize("name,size", [("auto", 3), ("two", 2)])
def test_sharded_cli_on_fewer_ranks_than_the_world(sharded, cli_unsharded,
                                                   name, size):
    """At world 4, ``--shard`` with no N (the reference's rule: 3 ranks for
    6 cells) and ``--shard 2`` leave ranks outside the mesh: they run
    nothing and return no rows, the mesh's ranks return rows equal to the
    unsharded grid's, and the record counts the mesh's ranks."""
    ranks, d, _, _ = sharded[4]
    skip = {"secs", "sweep_secs"}
    for r, got in enumerate(ranks):
        rows = got[f"cli_{name}_rows"]
        assert len(rows) == (6 if r < size else 0)
        for a, b in zip(rows, cli_unsharded):
            assert set(a) == set(b)
            for k in set(a) - skip:
                assert json.dumps(a[k], sort_keys=True, default=str) == \
                    json.dumps(b[k], sort_keys=True, default=str), k
        assert (got[f"cli_{name}_stdout"] == "") == (r > 0)
    assert (f"sharding the experiment axis over {size} rank(s) (E=6, "
            f"padding 0); chunk_rounds=None") in ranks[0]["cli_" + name
                                                          + "_stdout"]
    rec = json.loads((d / f"cli_{name}" / "BENCH_sweep.json")
                     .read_text())["sharded/fig4"]
    assert set(rec) == SHARDED_KEYS
    assert rec["devices"] == size and rec["bit_identical_metrics"] is True

def test_run_sweep_cells_off_the_mesh_runs_nothing():
    """A rank outside the mesh (index -1) gets no rows and runs no cell:
    the cells here would fail if built (an unknown dataset)."""
    from repro_torch.benchmarks import common as tc
    from repro_torch.benchmarks import sweep as tsweep
    from repro_torch.launch.mesh import SweepMesh

    cells = [dataclasses.replace(c, dataset="no-such-dataset") for c in
             tsweep.PRESETS["fig4"].build(("mnist",), (0,), 16)]
    off = SweepMesh("exp", (0, 1), None, -1)
    assert tc.run_sweep_cells(cells, mesh=off, device="cpu") == []

def test_pad_experiments_matches_the_reference():
    """Numpy and tensor leaves, pad 0 and 3, against the reference's."""
    import jax

    from repro.core.sweep import pad_experiments as jpad

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 2, 5)).astype(np.float32),
            "b": np.arange(3, dtype=np.int32)}
    assert pad_experiments(tree, 0) is tree
    for pad in (1, 3):
        want = jax.tree.map(np.asarray, jpad(tree, pad))
        got = pad_experiments(tree, pad)
        tensors = pad_experiments({k: torch.from_numpy(v)
                                   for k, v in tree.items()}, pad)
        for k in tree:
            assert got[k].shape == want[k].shape
            assert np.array_equal(got[k], want[k])
            assert np.array_equal(tensors[k].numpy(), want[k])
