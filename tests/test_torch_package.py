"""The port's two package rules: ``repro_torch`` never imports JAX or the
JAX package, and its entry points run on the CUDA card unless the caller
asks for the CPU."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core.decentralized import DecentralizedConfig, DecentralizedTrainer
from repro_torch.core.strategies import AggregationStrategy
from repro_torch.core.topology import ring
from repro_torch.models.paper_models import (
    classifier_accuracy,
    classifier_loss,
    ffn_apply,
)
from repro_torch.training.optimizer import sgd

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_with_jax_and_repro_blocked():
    """Every module of the port imports with ``jax``, ``repro``, the
    reference's top-level ``benchmarks`` and ``networkx`` made
    unimportable (``sys.modules[name] = None``; the GPU machine has no
    networkx), the kernel wrappers, the model layers, the graph layer, the
    coefficient programs, the entry points and the multi-device modules
    (meshes, distributed gossip, sharding rules) among them."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "repro", "benchmarks", "networkx"):
            sys.modules[name] = None
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for m in mods:
            importlib.import_module(m)
        for m in ("kernels.flash_attention", "kernels.ssm_scan",
                  "kernels.mla_attention", "kernels.gossip_mix",
                  "models.layers", "models.moe", "benchmarks.gossip_cost",
                  "core.topology", "core.coeffs", "core.sweep",
                  "core.analytics", "benchmarks.common",
                  "benchmarks.fig2_iid_vs_ood", "benchmarks.fig4_strategies",
                  "benchmarks.fig5_location", "benchmarks.fig6_topology",
                  "benchmarks.ablations", "benchmarks.sweep",
                  "benchmarks.serve_bench", "benchmarks.run",
                  "launch.serve", "launch.train", "launch.mesh",
                  "core.gossip", "sharding"):
            assert "repro_torch." + m in mods, m
        leaked = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "repro",
                                               "benchmarks", "networkx")
                        and sys.modules[k] is not None)
        assert not leaked, leaked
        print(len(mods))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def _trainer(device=None, **cfg):
    return DecentralizedTrainer(
        ring(4), AggregationStrategy("unweighted"), sgd(1e-2),
        classifier_loss(ffn_apply), classifier_accuracy(ffn_apply),
        DecentralizedConfig(rounds=1, local_epochs=1, **cfg), device=device)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer(device="cuda")
    from repro_torch.core.sweep import SweepEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepEngine(sgd(1e-2), classifier_loss(ffn_apply),
                    classifier_accuracy(ffn_apply))


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    for impl in ("einsum", "pallas", "edges", "sparse"):
        tr = _trainer(device="cpu", mix_impl=impl)
        assert tr.device == torch.device("cpu")
        np.testing.assert_allclose(tr.coeffs_for_round(0).sum(1).numpy(), 1.0,
                                   rtol=1e-6)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
