"""The port's run-time contract checks (``repro_torch.analysis``) and
``SweepEngine.traceable`` against the reference's ``repro.analysis``, on
the CPU.

* every combo of the ``engine-matrix`` preset (the reference's 49) is
  clean, and its mix-kernel calls in one round equal the reference's
  ``pallas_call`` count in the same combo's scan body (the reference's
  programs traced with ``jax.make_jaxpr``, never compiled; the mesh
  combos over a one-device mesh on each side: a one-rank gloo group here,
  the one CPU device there);
* the budgets' counterparts (``mix_eqn_budget``, ``mix_impl_budget``,
  ``mix_accum_upcasts``) equal the reference's for one experiment;
* each rule trips on a planted fault in the engine's real step with the
  whole catalog on, and only that rule: an extra matrix product in the
  mix, an ``(R, n, n)`` stack uploaded in a round, an f64 tensor, an
  ``.item()`` in a round, a chunk that keeps its old carry (the reference's
  ``tests/test_analysis.py`` fixtures);
* ``traceable(...)``'s ``fn(*args)`` equals ``run`` over the same rounds
  bit for bit (params, optimizer state, history), in each mode;
* the ``serve`` preset is clean (exactly one flash call a layer in the
  fleet prefill); the CLI and the ``torchlint`` fixture.

The reference forbids int64 in its programs; torch indexes in int64
(``index``, ``gather`` and ``argmax`` take or give it), so the port's
``DtypeFlow`` forbids f64 and c128 only.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.analysis import (
    ConstantFootprint,
    DtypeFlow,
    FusionBudget,
    HostSync,
    OpRecorder,
    analyze,
    count_calls,
    count_ops,
    region,
    round_scope,
)
from repro_torch.analysis import presets as pr
from repro_torch.analysis.pytest_plugin import torchlint  # noqa: F401

torch.set_num_threads(2)

COMBOS = pr.engine_matrix_combos()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_matrix():
    """The port's engine-matrix reports, by combo name."""
    return {r.name: r for r in pr.run_preset("engine-matrix", device="cpu")}


@pytest.fixture(scope="module")
def reference_calls():
    """The reference's ``pallas_call`` count in each combo's round scope:
    its own presets traced with ``jax.make_jaxpr``."""
    import jax
    from repro.analysis import presets as jpr
    from repro.analysis.rules import AnalysisContext
    from repro.analysis.walker import count_primitives

    out = {}
    for combo in jpr.engine_matrix_combos():
        fn, args, _ = jpr._traceable(combo)
        scoped = AnalysisContext(jax.make_jaxpr(fn)(*args)).scoped(
            jpr._scope(combo))
        out[combo.name] = count_primitives(
            scoped, names=("pallas_call",)).get("pallas_call", 0)
    return out


def test_engine_matrix_is_the_reference_matrix():
    from repro.analysis import presets as jpr

    assert [c.name for c in COMBOS] == \
        [c.name for c in jpr.engine_matrix_combos()]
    assert len(COMBOS) == 49


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: c.name)
def test_engine_matrix_combo_is_clean(combo, port_matrix):
    report = port_matrix[combo.name]
    assert report.ok, str(report)
    assert [o.rule for o in report.outcomes] == [
        "fusion-budget", "constant-footprint", "dtype-flow", "donation",
        "host-sync"]


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: c.name)
def test_mix_kernel_calls_equal_the_reference(combo, port_matrix,
                                              reference_calls):
    measured = port_matrix[combo.name].outcome("fusion-budget").measured
    assert measured["kernel_call"] == reference_calls[combo.name]


@pytest.mark.parametrize("impl", pr.IMPLS)
def test_budgets_equal_the_reference(impl):
    """``mix_impl_budget``/``mix_eqn_budget`` (calls, products) equal the
    reference's (``pallas_call``, ``dot_general``) for one experiment, on
    every robust rule and a support whose circulant schedule falls back;
    ``mix_accum_upcasts`` is the reference's policy."""
    import repro.core.decentralized as jdec
    import repro.kernels.gossip_mix as jgm

    from repro_torch.core.decentralized import mix_impl_budget
    from repro_torch.kernels.gossip_mix import mix_accum_upcasts

    ring = pr._host_setting()["support"]
    # a random matching: degree 1, many ring offsets, so the circulant
    # schedule falls back to the einsum
    pairs = np.random.default_rng(0).permutation(32).reshape(-1, 2)
    matching = np.eye(32)
    matching[pairs[:, 0], pairs[:, 1]] = matching[pairs[:, 1], pairs[:, 0]] = 1
    for support in (None, ring, matching):
        for robust in ("mean", "norm_clip", "trimmed", "median"):
            try:
                want = jdec.mix_impl_budget(impl, 6, mix_support=support,
                                            robust=robust)
            except ValueError:
                with pytest.raises(ValueError):
                    mix_impl_budget(impl, 6, mix_support=support,
                                    robust=robust)
                continue
            got = mix_impl_budget(impl, 6, mix_support=support,
                                  robust=robust)
            assert got == {"kernel_call": want["pallas_call"],
                           "matmul": want["dot_general"]}, (support, robust)
    assert mix_impl_budget("einsum", 6, experiments=2)["matmul"] == 12
    for m32 in (True, False):
        for low in (True, False):
            assert mix_accum_upcasts(impl, m32, low) == \
                jgm.mix_accum_upcasts(impl, m32, low)


# ----------------------------------------------------------------------
# planted faults in the engine's real step: exactly one rule trips
# ----------------------------------------------------------------------
def _planted(monkeypatch, mix=None, mode="scanned", step=None):
    """The preset's ``pallas`` stack combo through a fresh engine whose
    ``mix_plane`` is ``mix(real, params, coeffs, mix_in_float32)``, its
    step wrapped by ``step``; the whole catalog on."""
    from repro_torch.kernels import gossip_mix as gm

    real = gm.mix_plane
    if mix is not None:
        monkeypatch.setattr(gm, "mix_plane", lambda p, c, mix_in_float32=True:
                            mix(real, p, c, mix_in_float32))
    engine = pr._engine.__wrapped__("pallas", True, "mean", "cpu")
    monkeypatch.setattr(pr, "_engine", lambda *a: engine)
    combo = pr.Combo(mode, "pallas", "stack")
    fn, args, kwargs = pr._traceable(combo, CPU)
    if step is not None:
        fn = step(fn)
    return analyze(fn, *args, rules=pr.rules_for(combo), name=combo.name,
                   device=CPU, **kwargs)


def _only(report, rule):
    assert report.failed_rules() == [rule], str(report)


def test_healthy_step_passes_the_catalog(monkeypatch):
    report = _planted(monkeypatch, mix=lambda real, p, c, m: real(p, c, m))
    assert report.ok, str(report)


def test_extra_product_trips_fusion_budget(monkeypatch):
    def mix(real, p, c, m32):
        c @ c                                    # planted: an extra GEMM
        return real(p, c, m32)

    report = _planted(monkeypatch, mix)
    _only(report, "fusion-budget")
    assert "matmul: expected exactly 8" in report.findings[0].message


def test_uploaded_stack_trips_constant_footprint(monkeypatch):
    from repro_torch import to_device

    def mix(real, p, c, m32):
        stack = to_device(np.zeros((pr.ROUNDS,) + tuple(c.shape[-2:]),
                                   np.float32), c.device)   # planted
        return real(p, c + stack[0, None], m32)

    report = _planted(monkeypatch, mix)
    _only(report, "constant-footprint")
    assert "per-upload cap" in report.findings[0].message
    assert report.outcome("constant-footprint").measured["total_bytes"] \
        >= pr.ROUNDS * pr.N_NODES ** 2 * 4


def test_f64_tensor_trips_dtype_flow(monkeypatch):
    def mix(real, p, c, m32):
        c = (c.double() * 1.0).float()           # planted: an f64 pass
        return real(p, c, m32)

    report = _planted(monkeypatch, mix)
    _only(report, "dtype-flow")
    assert "float64" in report.findings[0].message


def test_item_in_the_round_trips_host_sync(monkeypatch):
    def mix(real, p, c, m32):
        float(c.sum())                           # planted: a host read
        return real(p, c, m32)

    report = _planted(monkeypatch, mix)
    _only(report, "host-sync")
    assert "_local_scalar_dense" in report.findings[0].message


def test_chunk_keeping_its_carry_trips_donation(monkeypatch):
    kept = []

    def step(fn):
        def leaky(run, a, b):
            kept.append((run.params, run.opt))   # planted: the old carry
            return fn(run, a, b)
        return leaky

    report = _planted(monkeypatch, mode="chunked", step=step)
    _only(report, "donation")
    measured = report.outcome("donation").measured
    assert measured["released"] == 0 and measured["carry_leaves"] == 7


def test_rule_specifics():
    """Fusion budgets are exact, both ways; the kernel-upcast knob follows
    ``mix_in_float32`` on a bf16 plane; ``HostSync`` sees a boolean-mask
    index; the upload caps read ``to_device``."""
    from repro_torch import to_device
    from repro_torch.kernels.gossip_mix import gossip_plane

    x = torch.ones(4, 4)
    assert not analyze(lambda: x @ x, rules=[FusionBudget.of(
        {"matmul": 0}, scope="all")]).ok
    assert analyze(lambda: x @ x, rules=[FusionBudget.of(
        {"matmul": 1}, scope="all")]).ok
    plane = torch.ones(4, 256, dtype=torch.bfloat16)
    c = torch.full((4, 4), 0.25)
    for m32 in (True, False):
        fn = lambda: gossip_plane(plane, c, mix_in_float32=m32)
        assert analyze(fn, rules=[DtypeFlow(expect_kernel_upcasts=m32)]).ok
        assert not analyze(fn, rules=[DtypeFlow(
            expect_kernel_upcasts=not m32)]).ok
    assert analyze(lambda: gossip_plane(plane, c), rules=[FusionBudget.of(
        {"gossip_plane": 1, "matmul": 0}, scope="all")]).ok
    masked = analyze(lambda: x[x > 0], rules=[HostSync(scope="all")])
    assert masked.failed_rules() == ["host-sync"]
    big = analyze(lambda: to_device(np.zeros(1024, np.float32), "cpu"),
                  rules=[ConstantFootprint(max_total_bytes=1 << 20,
                                           max_upload_bytes=512)])
    assert "per-upload cap" in big.findings[0].message


def test_walker_regions_and_scopes():
    """A region records nothing without a recorder; rounds are numbered,
    the round scope is the first round's events; kernel regions keep
    their ops out of the program's counts; ``calls`` counts CPU calls."""
    from repro_torch.kernels import gossip_mix as gm

    with region("round"):
        pass
    x = torch.ones(3, 3)
    calls = gm.gossip_plane.calls
    with OpRecorder() as rec:
        for _ in range(2):
            with region("round"):
                x = x @ x
                gm.gossip_plane(x, torch.eye(3))
    assert gm.gossip_plane.calls == calls + 2
    first = round_scope(rec.events)
    assert count_ops(first, names=("mm",)) == {"mm": 1}
    assert count_calls(first) == {"gossip_plane": 1}
    assert count_calls(rec.events) == {"gossip_plane": 2}
    assert count_ops(rec.events, names=("mm",),
                     exclude_within=()).get("mm") == 4
    assert round_scope([]) == []


# ----------------------------------------------------------------------
# SweepEngine.traceable against SweepEngine.run
# ----------------------------------------------------------------------
def _inputs(rounds=None):
    s = pr._host_setting()
    r = rounds or pr.ROUNDS
    return (pr._params0("float32"), s["stacks"][:, :r], s["bank"],
            s["indices"][:, :r], s["data_idx"], s["test_iid"],
            s["test_ood"])


def _same(a, b):
    for x, y in zip(tree_util.leaves(a), tree_util.leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", pr.MODES)
def test_traceable_step_equals_run(mode):
    """The step the engine hands out for analysis, run as it is, gives
    what ``run`` gives over the same rounds, bit for bit: all rounds
    (scanned, mesh over one rank), the first chunk (chunked: ``run`` over
    those rounds), the first round with its evaluation (unrolled: a run
    of one round)."""
    engine = pr._engine.__wrapped__("edges", True, "mean", "cpu")
    with pr.one_rank_mesh() as mesh:
        fn, args, kwargs = engine.traceable(
            *_inputs(), batch_size=pr.BATCH, mode=mode, mesh=mesh,
            chunk_rounds=pr.CHUNK_ROUNDS)
        hist = fn(*args, **kwargs)
        run_ = args[0]
        rounds = {"chunked": pr.CHUNK_ROUNDS, "unrolled": 1}.get(mode)
        res = engine.run(*_inputs(rounds), batch_size=pr.BATCH,
                         unroll_eval=mode == "unrolled",
                         mesh=mesh if mode == "mesh" else None)
    assert args[1:] == (0, rounds or pr.ROUNDS)
    _same(run_.params, res.params)
    _same(run_.opt, res.opt_state)
    for h, want in zip(hist, (res.train_loss, res.iid_acc, res.ood_acc)):
        assert np.array_equal(h.numpy(), want)


def test_traceable_donation_knob():
    """``donate=False`` hands out a step that keeps its input carry (a
    step whose inputs are not donated); the default chunked step drops
    it."""
    import weakref

    engine = pr._engine.__wrapped__("einsum", True, "mean", "cpu")
    alive = {}
    for donate in (None, False):
        fn, args, kwargs = engine.traceable(
            *_inputs(), batch_size=pr.BATCH, mode="chunked",
            chunk_rounds=pr.CHUNK_ROUNDS, donate=donate)
        refs = [weakref.ref(x) for x in tree_util.leaves(args[0].params)]
        fn(*args, **kwargs)
        alive[donate] = sum(r() is not None for r in refs)
    assert alive == {None: 0, False: 6}
    with pytest.raises(KeyError, match="unknown mode"):
        engine.traceable(*_inputs(), batch_size=pr.BATCH, mode="vmapped")


# ----------------------------------------------------------------------
# the serve preset, the CLI, the fixture
# ----------------------------------------------------------------------
def test_serve_preset_is_clean():
    reports = {r.name: r for r in pr.run_preset("serve", device="cpu")}
    assert sorted(reports) == sorted(c.name for c in pr.serve_combos())
    for r in reports.values():
        assert r.ok, str(r)
    budget = reports["serve/fleet-prefill"].outcome("fusion-budget")
    assert budget.measured == {"flash_attention":
                               pr._serve_config().n_layers}


def test_cli(tmp_path, monkeypatch, capsys):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "ANALYSIS.json"
    only = ["--only", "^scanned/(einsum|pallas)/stack$", "--device", "cpu",
            "--out", str(out)]
    assert main(["--preset", "engine-matrix"] + only) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["n_combos"] == 2
    assert main(["--list"]) == 0
    assert len(capsys.readouterr().out.splitlines()) >= 49
    monkeypatch.setitem(pr.EINSUM_BASELINE, ("scanned", "stack"),
                        {"kernel_call": 0, "matmul": 19})
    assert main(["--preset", "engine-matrix"] + only) == 1
    assert not json.loads(out.read_text())["ok"]
    assert main(["--only", "nothing-matches", "--device", "cpu",
                 "--out", str(out)]) == 2


def test_torchlint_fixture(torchlint):
    x = torch.ones(4, 4)
    assert torchlint.count(lambda: x @ x, names=("mm",)) == {"mm": 1}
    from repro_torch.kernels.gossip_mix import gossip_plane

    assert torchlint.kernel_calls(lambda: gossip_plane(x, torch.eye(4))) == 1
    torchlint.check(lambda: x @ x, rules=[torchlint.FusionBudget.of(
        {"matmul": 1}, scope="all")])
    with pytest.raises(AssertionError):
        torchlint.check(lambda: x @ x, rules=[torchlint.FusionBudget.of(
            {"matmul": 2}, scope="all")])
