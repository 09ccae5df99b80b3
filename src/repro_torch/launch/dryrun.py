"""Memory dry-run: run each (architecture × input shape × mesh) step on fake
tensors and read off its bytes, FLOPs and roofline terms (port of
``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internvl2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each step for its TPU mesh and reads
XLA's memory and cost analyses.  The port has no compiler to ask, so it
runs its real step — ``make_train_step``, ``make_forward_prefill(...,
last_only=True)`` or ``make_serve_step``, the reference's ``build_step``
— on the fake trees of ``launch.specs.input_specs`` (no memory is
allocated; the plain kernel versions run, as for any CPU tensor) and
records, a device:

* **resident bytes** (params, optimizer, batch, cache): each leaf's bytes
  over its partition spec's shard counts on the mesh (a dim split over
  axes of total size k holds ⌈d / k⌉ of it);
* **peak live bytes**: a ``TorchDispatchMode`` (:class:`LiveBytes`) that
  tallies the storages alive after every aten op, with weak references
  to see them freed.  It is chosen over
  ``torch.distributed._tools.mem_tracker.MemTracker``, whose accounting
  is by ``nn.Module`` (the port's models are functions) and whose API is
  private.  A kernel region (``_trace.KERNEL_REGIONS``) is opaque: the plain
  version's temporaries do not count, only what is alive when the call
  returns, since the card's kernel allocates its output alone.  The step
  runs once for the whole job, so on a mesh of several devices the
  per-device peak is the global peak over the device count (even
  sharding: modeled); on a one-device mesh it is the step's own peak;
* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode``, which in
  eager mode counts every layer (XLA's ``cost_analysis`` visits a loop
  body once: reference ``benchmarks/roofline.py:9-17``).  The plain
  attention versions compute the full S × S square, which the kernels
  (and the roofline's formula) halve under the causal mask, so
  ``flops_per_chip`` counts masked pairs too;
* **bytes accessed**: every non-view aten op's inputs and outputs (the
  plain versions' included), as XLA's bytes-accessed sums operands;
* **collective bytes** from the roofline's analytic plan
  (``benchmarks.roofline.step_collective_bytes``): with no HLO to parse,
  the reference's ``collective_bytes`` has no counterpart;
* the three roofline terms against the H100 datasheet constants
  (``benchmarks/roofline.py``), and whether the pair fits the device's
  80 GB (peak ≤ ``HBM_PER_CHIP``).

``mesh_shape`` of one device (``{"pod": 1, "node": 1, "fsdp": 1,
"model": 1}``) models one H100 holding every node, so the same function
answers whether a fleet of n nodes fits the card.  The CLI writes under
``artifacts_torch/dryrun/``.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Union

import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree as tree_util
from repro_torch._trace import KERNEL_REGIONS, Listener
from repro_torch.analysis.walker import tensors_in
from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.configs.registry import ARCHS, get_config, get_parallel
from repro_torch.launch.specs import (
    LONG_CTX_SKIP,
    DryRunSpec,
    applicable_shapes,
    input_specs,
)

__all__ = ["LiveBytes", "dry_run_pair", "resident_bytes",
           "resident_per_device", "mesh_sizes", "build_step", "ONE_DEVICE"]

ONE_DEVICE = {"pod": 1, "node": 1, "fsdp": 1, "model": 1}


class LiveBytes(Listener):
    """Bytes of the storages alive across a run, and their peak.

    ``track(tree)`` counts tensors that exist before the run (the step's
    inputs); every op's outputs are counted as they appear, once a
    storage, and uncounted when the storage is freed.  Inside a kernel
    region the peak is not raised (the plain version's temporaries are
    not the kernel's); on leaving it the peak takes what is alive.
    ``accessed`` sums the bytes of every non-view op's tensor inputs and
    outputs."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self._refs = WeakIdKeyDictionary()
        self._opaque = 0

    def enter_region(self, name: str) -> None:
        self._opaque += name in KERNEL_REGIONS

    def exit_region(self, name: str) -> None:
        if name in KERNEL_REGIONS:
            self._opaque -= 1
            if not self._opaque:
                self.peak = max(self.peak, self.live)

    def _freed(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._refs:
            return
        n = st.nbytes()
        self._refs[st] = weakref.ref(st, functools.partial(self._freed, n))
        self.live += n
        if not self._opaque:
            self.peak = max(self.peak, self.live)

    def track(self, tree) -> None:
        for leaf in tree_util.leaves(tree):
            if isinstance(leaf, torch.Tensor):
                self._add(leaf)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = tensors_in(out)
        if not func.is_view:
            ins = tensors_in((args, kwargs))
            self.accessed += sum(x.numel() * x.element_size()
                                 for x in ins + outs)
        for x in outs:
            self._add(x)
        return out


def mesh_sizes(mesh_shape, multi_pod: bool, pcfg) -> Dict[str, int]:
    """``{axis: size}`` of the modeled mesh: ``mesh_shape`` as a dict or a
    ``(pod, node, fsdp, model)`` tuple, by default the production mesh
    (``launch.mesh.training_mesh_shape``)."""
    if mesh_shape is None:
        from repro_torch.launch.mesh import training_mesh_shape

        shape, names = training_mesh_shape(pcfg.n_nodes, tp=pcfg.tp_degree,
                                           multi_pod=multi_pod)
        return dict(zip(names, shape))
    if isinstance(mesh_shape, dict):
        return {**ONE_DEVICE, **mesh_shape}
    return dict(zip(("pod", "node", "fsdp", "model"), mesh_shape))


def _shard_factor(spec, sizes: Dict[str, int], dim: int) -> int:
    entries = tuple(spec)
    if dim >= len(entries) or entries[dim] is None:
        return 1
    axes = entries[dim] if isinstance(entries[dim], tuple) else (entries[dim],)
    return math.prod(sizes.get(a, 1) for a in axes if a is not None)


def resident_bytes(leaf_shape, itemsize: int, spec,
                   sizes: Dict[str, int]) -> int:
    """One device's bytes of a leaf laid out by ``spec``: each dim split
    over its axes (⌈d / k⌉ a device)."""
    n = 1
    for d, size in enumerate(leaf_shape):
        n *= -(-size // _shard_factor(spec, sizes, d))
    return n * itemsize


def _tree_resident(tree, specs, sizes) -> int:
    """Sum over a tree's leaves, matched to its spec tree by path (a spec
    may stand for a whole subtree, e.g. ``P()`` for the coefficients)."""
    from repro_torch.sharding import PartitionSpec

    if isinstance(specs, PartitionSpec) or specs is None:
        spec = specs if specs is not None else PartitionSpec()
        return sum(resident_bytes(tuple(x.shape), x.element_size(), spec,
                                  sizes)
                   for x in tree_util.leaves(tree))
    if isinstance(tree, dict):
        return sum(_tree_resident(tree[k], specs[k], sizes) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_tree_resident(t, s, sizes) for t, s in zip(tree, specs))
    raise TypeError(f"no spec for {type(tree).__name__}")


def build_step(spec: DryRunSpec, cfg, pcfg, skip_nonfinite: bool = False):
    """The reference's steps: ``make_train_step`` (AdamW), the last-only
    ``make_forward_prefill``, ``make_serve_step``.  A prefill takes the
    reference's ``"chunked"`` attention; a train step ``"einsum"``, as
    ``make_train_step`` runs by default: the port's chunked attention
    writes its output blocks in place, which ``torch.func.vmap`` of a
    gradient cannot take."""
    from repro_torch.models.transformer import ForwardOptions
    from repro_torch.serving.serve_step import (make_forward_prefill,
                                                make_serve_step)
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.train_step import make_train_step

    opts = ForwardOptions(
        attn_impl="einsum" if spec.kind == "train" else "chunked")
    if spec.kind == "train":
        opt = make_optimizer("adamw", 3e-4, skip_nonfinite=skip_nonfinite)
        return make_train_step(cfg, pcfg, opt, opts=opts)
    if spec.kind == "prefill":
        return make_forward_prefill(cfg, opts=opts, last_only=True)
    return make_serve_step(cfg)


def resident_per_device(spec: DryRunSpec, sizes: Dict[str, int],
                        skip_nonfinite: bool = False):
    """``(args, bytes)``: the step's arguments (the train step's optimizer
    state behind the nonfinite guard with ``skip_nonfinite``) and one
    device's resident bytes of each kind (``params``, ``optimizer``,
    ``batch`` — the train step's coefficients included — ``cache``,
    ``total``) on the mesh of axis ``sizes``."""
    args, specs = list(spec.abstract_args), list(spec.in_specs)
    names = {"train": ("params", "optimizer", "batch", "coeffs"),
             "prefill": ("params", "batch"),
             "decode": ("params", "batch", "cache")}[spec.kind]
    if spec.kind == "train" and skip_nonfinite:
        from repro_torch.sharding import PartitionSpec
        from repro_torch.training.optimizer import make_optimizer

        with spec.fake_mode:
            args[1] = make_optimizer("adamw", 3e-4,
                                     skip_nonfinite=True).init(args[0])
        specs[1] = {"inner": specs[1],
                    "skipped": PartitionSpec(("pod", "node"))}
    resident = {name: _tree_resident(arg, s, sizes)
                for name, arg, s in zip(names, args, specs)}
    if spec.kind == "train":   # the coefficients ride with the batch
        resident["batch"] += resident.pop("coeffs")
    resident["total"] = sum(resident.values())
    return args, resident


def dry_run_pair(arch: str, shape: Union[str, InputShape],
                 multi_pod: bool = False, pcfg=None, mesh_shape=None,
                 skip_nonfinite: bool = False,
                 verbose: bool = False) -> Dict[str, Any]:
    """One pair's record (see the module docstring).  ``shape``: a name of
    ``SHAPES`` or an ``InputShape`` (a card run's own batch and length);
    ``mesh_shape``: the modeled devices (:func:`mesh_sizes`;
    :data:`ONE_DEVICE` for one H100); ``skip_nonfinite``: the train
    step's optimizer behind the nonfinite guard."""
    from repro_torch.benchmarks import roofline as rl

    cfg = get_config(arch)
    pcfg = pcfg or get_parallel(arch)
    t0 = time.time()
    spec = input_specs(arch, shape, multi_pod=multi_pod, cfg=cfg, pcfg=pcfg)
    shape = spec.shape
    sizes = mesh_sizes(mesh_shape, multi_pod, pcfg)
    n_dev = math.prod(sizes.values())
    step = build_step(spec, cfg, pcfg, skip_nonfinite)

    args, resident = resident_per_device(spec, sizes, skip_nonfinite)

    live = LiveBytes()
    live.track(args)
    with spec.fake_mode:
        flops_mode = FlopCounterMode(display=False)
        with flops_mode, live:
            out = step(*args)
        del out, args
    flops = float(flops_mode.get_total_flops())
    peak = live.peak / n_dev

    plan = rl.resolve_plan(cfg, pcfg, shape, multi_pod)
    coll = rl.step_collective_bytes(cfg, pcfg, shape, plan,
                                    pcfg.gossip_schedule)["per_chip"]
    t_compute = flops / n_dev / rl.PEAK_FLOPS
    t_memory = live.accessed / n_dev / rl.HBM_BW
    t_collective = coll / rl.ICI_BW if n_dev > 1 else 0.0
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective)], key=lambda kv: kv[1])[0]
    tokens = shape.global_batch * (shape.seq_len if spec.kind != "decode"
                                   else 1)
    mult = 6 if spec.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    result = dict(
        arch=arch, shape=shape.name, kind=spec.kind,
        mesh="x".join(f"{k}{v}" for k, v in sizes.items()),
        n_chips=n_dev, n_nodes=spec.n_global_nodes,
        run_s=round(time.time() - t0, 1),
        flops_per_chip=flops / n_dev,
        bytes_per_chip=live.accessed / n_dev,
        collective_bytes=coll if n_dev > 1 else 0.0,
        t_compute_s=t_compute, t_memory_s=t_memory,
        t_collective_s=t_collective, dominant=dominant,
        model_flops=model_flops, model_flops_per_chip=model_flops / n_dev,
        useful_flops_ratio=model_flops / flops if flops else 0.0,
        params_total=cfg.param_count(),
        params_active=cfg.active_param_count(),
        memory=dict(resident_per_device=resident,
                    peak_per_device=peak,
                    hbm_per_device=rl.HBM_PER_CHIP),
        fits_hbm=peak <= rl.HBM_PER_CHIP,
        meta=spec.meta, modeled=True)
    if verbose:
        print(f"[dryrun] {arch:24s} {shape.name:12s} {result['mesh']:24s} "
              f"flops/dev={result['flops_per_chip']:.3e} "
              f"resident/dev={resident['total'] / 1e9:.2f}GB "
              f"peak/dev={peak / 1e9:.2f}GB fits={result['fits_hbm']} "
              f"dom={dominant} ({result['run_s']} s)", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "one"],
                    help="the production pod, two pods, both, or one H100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts_torch/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = {"pod": [(False, None)], "multipod": [(True, None)],
              "both": [(False, None), (True, None)],
              "one": [(False, ONE_DEVICE)]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    results, failures = [], []
    for arch in archs:
        shapes = ([SHAPES[args.shape]] if args.shape
                  else applicable_shapes(arch))
        for shape in shapes:
            if shape.name == "long_500k" and arch in LONG_CTX_SKIP:
                results.append(dict(arch=arch, shape=shape.name,
                                    skipped=LONG_CTX_SKIP[arch]))
                continue
            for mp, mesh in meshes:
                tag = (f"{arch}__{shape.name}__"
                       f"{'one' if mesh else ('2pod' if mp else '1pod')}")
                path = os.path.join(args.out, tag + ".json")
                try:
                    r = dry_run_pair(arch, shape.name, mp, mesh_shape=mesh,
                                     verbose=True)
                    results.append(r)
                    with open(path, "w") as fh:
                        json.dump(r, fh, indent=1)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    failures.append((tag, repr(e)))
    summary = os.path.join(args.out, "summary.json")
    with open(summary, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"\n{len(results)} results → {summary}; {len(failures)} failures")
    for tag, err in failures:
        print("FAIL", tag, err[:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
