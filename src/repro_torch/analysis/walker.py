"""What a run did, op by op: the recorder the trace-time contracts read
(port of ``repro/analysis/walker.py``).

The reference walks the jaxpr that ``jax.make_jaxpr`` returns.  An eager
PyTorch program has no such graph, so the port records the program as it
runs instead: :class:`OpRecorder` is a ``TorchDispatchMode`` that notes
every aten op executed inside it (its dtypes, shapes and devices) with
the *region path* it ran in.  Regions are the counterpart of the
reference's enclosing primitives (``scan``, ``pallas_call``): the code
marks them with ``repro_torch._trace.region``, a context manager that
does nothing unless a listener is active, placed

* in every kernel wrapper (:data:`KERNEL_REGIONS`: the four gossip
  wrappers, flash, MLA, the RWKV-6 scan, through ``_trace.kernel_entry``,
  whose ``calls`` counter counts CPU and CUDA calls alike);
* in the round loop (``core.decentralized.make_scan_fn``: ``"round"``
  around each round, ``"eval"`` around its evaluation) and in the round
  functions (``"local_train"``, ``"mix"``).

``repro_torch.to_device``, the port's one host-to-device path, tells the
listeners of each upload (``_trace.note_upload``; on the CPU the copy is
no op at all).

The recorder keeps metadata only, never a tensor, so it does not change
what the run keeps alive.  A region's instances are numbered in order of
entry (``("round", 0)`` is the first round); :func:`round_scope` is the
counterpart of the reference's ``outermost_scan_body``: the events of the
first round, or every event when the program has no round.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import (Iterable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch._trace import KERNEL_REGIONS, Listener, region

__all__ = [
    "KERNEL_REGIONS",
    "MATMUL_OPS",
    "OpRecord",
    "RegionEntry",
    "Upload",
    "OpRecorder",
    "region",
    "iter_ops",
    "count_ops",
    "count_calls",
    "round_scope",
]

#: aten matrix products (the reference's ``dot_general``); ``matmul``,
#: ``einsum``, ``tensordot`` and ``linear`` reach the dispatcher as these.
MATMUL_OPS: Tuple[str, ...] = ("mm", "bmm", "addmm", "baddbmm", "addbmm",
                               "mv", "addmv", "dot")

#: Path entries are ``(region name, instance)`` of the enclosing regions,
#: outermost first.
Path = Tuple[Tuple[str, int], ...]


class TensorMeta(NamedTuple):
    dtype: torch.dtype
    shape: Tuple[int, ...]
    device: str

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.dtype.itemsize


class OpRecord(NamedTuple):
    """One aten op: ``op`` the overload packet (``"mm"``), ``target`` the
    overload (``"aten.mm.default"``), tensor inputs and outputs."""

    op: str
    target: str
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    path: Path


@dataclasses.dataclass(frozen=True)
class RegionEntry:
    """A region entered; ``path`` ends with the region itself."""

    name: str
    path: Path


@dataclasses.dataclass(frozen=True)
class Upload:
    """A host array placed on a device through ``repro_torch.to_device``."""

    meta: TensorMeta
    path: Path


def tensors_in(tree, out: Optional[list] = None) -> list:
    """The tensors in an op's arguments or outputs (tuples, lists and
    dicts of them), in order: a dispatch mode's hot path, cheaper than a
    general tree flatten."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                tensors_in(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors_in(x, out)
    return out


def _metas(tree) -> Tuple[TensorMeta, ...]:
    return tuple([TensorMeta(x.dtype, tuple(x.shape), x.device.type)
                  for x in tensors_in(tree)])


@functools.lru_cache(maxsize=None)
def _names(func) -> Tuple[str, str]:
    packet = getattr(func, "overloadpacket", func)
    return getattr(packet, "__name__", str(packet)), str(func)


class OpRecorder(Listener):
    """Records every aten op run inside it, every region entered and every
    upload, in order (``events``)."""

    def __init__(self):
        super().__init__()
        self.events: List[object] = []
        self._stack: List[Tuple[str, int]] = []
        self._instances: Counter = Counter()

    def enter_region(self, name: str) -> None:
        self._stack.append((name, self._instances[name]))
        self._instances[name] += 1
        self.events.append(RegionEntry(name, tuple(self._stack)))

    def exit_region(self, name: str) -> None:
        if self._stack and self._stack[-1][0] == name:
            self._stack.pop()

    def upload(self, t: torch.Tensor) -> None:
        self.events.append(Upload(_metas(t)[0], tuple(self._stack)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op, target = _names(func)
        self.events.append(OpRecord(op, target, _metas((args, kwargs)),
                                    _metas(out), tuple(self._stack)))
        return out


def _within(path: Path, names: frozenset) -> bool:
    return any(name in names for name, _ in path)


def iter_ops(events: Iterable[object],
             exclude_within: Iterable[str] = ()) -> Iterator[OpRecord]:
    """The op records, skipping those inside any of ``exclude_within``."""
    excl = frozenset(exclude_within)
    for ev in events:
        if isinstance(ev, OpRecord) and not (excl and _within(ev.path, excl)):
            yield ev


def count_ops(events: Iterable[object],
              names: Optional[Sequence[str]] = None,
              exclude_within: Iterable[str] = KERNEL_REGIONS) -> Counter:
    """Ops by overload packet, kernel regions excluded by default (a
    matrix product inside a plain kernel version is the kernel's MAC, not
    the program's, as the reference skips ``pallas_call`` bodies)."""
    keep = None if names is None else frozenset(names)
    counts: Counter = Counter()
    for ev in iter_ops(events, exclude_within):
        if keep is None or ev.op in keep:
            counts[ev.op] += 1
    return counts


def count_calls(events: Iterable[object],
                names: Sequence[str] = KERNEL_REGIONS) -> Counter:
    """Entries of the named regions (a kernel region's entries are its
    wrapper's calls), nested ones included."""
    keep = frozenset(names)
    return Counter(ev.name for ev in events
                   if isinstance(ev, RegionEntry) and ev.name in keep)


def round_scope(events: Sequence[object], name: str = "round") -> list:
    """The events of the first ``name`` region (the region entry itself
    excluded), or all events when there is none: the counterpart of the
    reference's ``outermost_scan_body``, which falls back to the whole
    program for the unrolled trace."""
    first = (name, 0)
    inside = [ev for ev in events
              if not (isinstance(ev, RegionEntry) and ev.path[-1] == first)
              and first in getattr(ev, "path", ())]
    seen = any(isinstance(ev, RegionEntry) and ev.path[-1] == first
               for ev in events)
    return inside if seen else list(events)
