"""The hooks that the program leaves for its tracers: named regions, the
kernel wrappers' entry, and the uploads of ``repro_torch.to_device``.

Every hook does nothing (one list test) unless a :class:`Listener` is
active.  A listener is a ``TorchDispatchMode`` that also hears which
region the ops run in (``enter_region``/``exit_region``) and what was
uploaded (``upload``): ``analysis.walker.OpRecorder`` records them for
the trace-time contracts, ``launch.dryrun.LiveBytes`` reads the kernel
regions to tally a step's live bytes.  This module depends on nothing
else in the package, so the kernels and the engine can mark their
regions without loading the tooling.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KERNEL_REGIONS", "Listener", "region", "note_upload",
           "kernel_entry"]

#: The kernel wrappers' regions: a plain version that runs on the CPU runs
#: inside one of these, so its ops are the kernel's, not the program's.
KERNEL_REGIONS: Tuple[str, ...] = (
    "gossip_plane", "gossip_edges", "gossip_robust", "gossip_mix",
    "flash_attention", "mla_attention", "rwkv_scan")

_LISTENERS: list = []


class Listener(TorchDispatchMode):
    """A dispatch mode that the hooks tell of regions and uploads while it
    is entered; the defaults ignore both."""

    def __enter__(self):
        _LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _LISTENERS.remove(self)

    def enter_region(self, name: str) -> None:
        pass

    def exit_region(self, name: str) -> None:
        pass

    def upload(self, t: torch.Tensor) -> None:
        pass


class region:
    """``with region("mix"): ...`` marks the ops inside for the listeners;
    free (one list test) when none is listening."""

    __slots__ = ("name", "_seen")

    def __init__(self, name: str):
        self.name = name
        self._seen: Tuple = ()

    def __enter__(self):
        if _LISTENERS:
            self._seen = tuple(_LISTENERS)
            for listener in self._seen:
                listener.enter_region(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        for listener in self._seen:
            listener.exit_region(self.name)
        self._seen = ()
        return False


def note_upload(t: torch.Tensor) -> None:
    """Tell the listeners that ``t`` was uploaded (``to_device``)."""
    for listener in tuple(_LISTENERS):
        listener.upload(t)


def kernel_entry(name: str):
    """Decorator for a kernel wrapper: ``<wrapper>.calls`` counts every
    call, CPU or CUDA (beside the wrapper's own ``launches``, which counts
    CUDA launches only: on the card ``calls == launches`` shows that no
    plain version ran), and while a listener is active the body runs
    inside ``region(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            wrapper.calls += 1
            if not _LISTENERS:
                return fn(*args, **kwargs)
            with region(name):
                return fn(*args, **kwargs)

        wrapper.calls = 0
        return wrapper

    return wrap
