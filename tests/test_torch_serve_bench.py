"""The port's fleet serving benchmark (``repro_torch.benchmarks.serve_bench``)
against the reference's (``benchmarks/serve_bench.py``) on the CPU.

* ``gen_requests`` and ``_percentiles`` equal the reference's exactly;
* ``run_fleet`` at ``BENCH_CFG``, from the reference's per-node inits
  carried over, gives the reference's outputs token for token, in the
  fleet mode and in the per-node loop;
* ``bench_fleet_size``: the two modes agree and the swap check passes,
  and the check fails when the plane row was not written;
* ``main --smoke`` writes the record under the reference's keys; the
  default device raises without a GPU.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import benchmarks.serve_bench as jsb
from repro.models import transformer as jt
from repro_torch.benchmarks import serve_bench as tsb
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

WORKLOADS = [
    dict(n_requests=12, seed=0),
    dict(n_requests=20, arrival_p=0.4, seed=3),
    dict(n_requests=7, prompt_lens=(2, 9), prompt_mix=(0.3, 0.7),
         max_new=(1, 5), max_new_mix=(0.5, 0.5), seed=11),
]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_gen_requests_and_percentiles_equal_the_reference(kw):
    """Arrival steps, prompts and budgets (numpy host code) and the
    latency percentiles, exactly."""
    got = tsb.gen_requests(tsb.ServeWorkload(**kw), 64)
    want = jsb.gen_requests(jsb.ServeWorkload(**kw), 64)
    assert got == want
    lat = list(np.random.default_rng(kw["seed"]).exponential(
        0.05, size=kw["n_requests"]))
    assert tsb._percentiles(lat) == jsb._percentiles(lat)
    assert dataclasses.asdict(tsb.ServeWorkload()) == dataclasses.asdict(
        jsb.ServeWorkload())


def test_bench_config_is_the_reference_s():
    assert {f.name: getattr(tsb.BENCH_CFG, f.name)
            for f in dataclasses.fields(jsb.BENCH_CFG)} == {
        f.name: getattr(jsb.BENCH_CFG, f.name)
        for f in dataclasses.fields(jsb.BENCH_CFG)}


def _reference_fleet(n, seed=0):
    """The reference's per-node inits (its ``bench_fleet_size``'s) and the
    same carried over to the port."""
    jp = jax.jit(jax.vmap(lambda k: jt.init_params(k, jsb.BENCH_CFG)))(
        jax.random.split(jax.random.key(seed), n))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


@pytest.mark.parametrize("vmapped", [True, False])
def test_run_fleet_is_token_identical_to_the_reference(vmapped):
    """A 2-node fleet, 2 slots a node, 10 requests of the default mixes:
    every request's greedy output equals the reference's, token for
    token, and both count the same scheduler steps and tokens."""
    work = tsb.ServeWorkload(n_requests=10, seed=5)
    jp, tp = _reference_fleet(2)
    got = tsb.run_fleet(tsb.BENCH_CFG, tp, 2, work, 2, 48, 8, vmapped,
                        repeats=1)
    want = jsb.run_fleet(jsb.BENCH_CFG, jp, 2, jsb.ServeWorkload(
        n_requests=10, seed=5), 2, 48, 8, vmapped, repeats=1)
    assert got["outputs"] == want["outputs"]
    for k in ("requests", "steps", "generated_tokens", "mode"):
        assert got["metrics"][k] == want["metrics"][k], k
    assert set(got["metrics"]) == set(want["metrics"])


def test_bench_fleet_size_passes_its_checks():
    """The fleet step and the per-node loop agree on the workload, and
    the swap check holds (the new params written into the plane row in
    place, the probes drained, their outputs a fresh fleet's on the
    swapped params)."""
    work = tsb.ServeWorkload(n_requests=6, seed=1)
    r = tsb.bench_fleet_size(2, work, 2, 48, 8, 0, device="cpu", repeats=1)
    assert r["outputs_identical"] and r["swap_no_rejit"]
    assert r["fleet_vmapped"]["requests"] == 6
    assert set(r) == {"n_nodes", "n_slots", "max_seq", "prefill_chunk",
                      "fleet_vmapped", "per_node_loop", "vmapped_speedup",
                      "outputs_identical", "swap_no_rejit"}


def test_swap_check_catches_a_row_that_was_not_written():
    """With ``swap_node`` made a no-op, the row does not hold the new
    parameters and the check fails; on a fleet whose swap works it
    holds."""
    _, tp = _reference_fleet(2)
    new = tt.init_params(torch.Generator().manual_seed(9), tsb.BENCH_CFG)
    work = tsb.ServeWorkload(n_requests=4, seed=2)
    run = tsb.run_fleet(tsb.BENCH_CFG, tp, 2, work, 2, 48, 8, True,
                        repeats=1)
    fleet = run["fleet"]
    fleet.swap_node = lambda node, params: None
    assert not tsb._swap_check(tsb.BENCH_CFG, fleet, new, 2, 2, 48, 8)
    fresh = tsb.run_fleet(tsb.BENCH_CFG, tp, 2, work, 2, 48, 8, True,
                          repeats=1)["fleet"]
    assert tsb._swap_check(tsb.BENCH_CFG, fresh, new, 2, 2, 48, 8)


def test_main_smoke_writes_the_reference_record(tmp_path, monkeypatch):
    """``--smoke --fleets 1,2 --device cpu``: exit 0, the record's keys
    are the reference's (plus the dtype, the device and what
    ``swap_no_rejit`` means); without a GPU the default device raises."""
    code = tsb.main(["--smoke", "--fleets", "1,2", "--repeats", "1",
                     "--device", "cpu", "--out", str(tmp_path)])
    assert code == 0
    rec = json.loads((tmp_path / "BENCH_serve.json").read_text())
    assert set(rec) == {"config", "fleets", "all_checks_passed",
                        "swap_no_rejit_means"}
    assert set(rec["config"]) == {"model", "n_layers", "d_model",
                                  "vocab_size", "dtype", "requests_per_node",
                                  "workload", "device"}
    assert rec["all_checks_passed"] and [f["n_nodes"] for f in
                                         rec["fleets"]] == [1, 2]
    for f in rec["fleets"]:
        for mode in ("fleet_vmapped", "per_node_loop"):
            assert {"p50_ms", "p95_ms", "p99_ms", "tokens_per_sec",
                    "mean_slot_occupancy"} <= set(f[mode])
    with pytest.raises(SystemExit):
        tsb.main(["--fleets", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsb.main(["--smoke"])
