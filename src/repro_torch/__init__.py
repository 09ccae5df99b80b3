"""PyTorch/CUDA port of the topology-aware decentralized learning system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``data/``, ``models/``, ``training/``, ``kernels/``) so
every module has a counterpart of the same name.  It imports ``torch``,
numpy and the standard library only — never ``jax`` and never ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; there is no helper that quietly falls back to the CPU.

TF32 is switched off here, for the whole process that imports the port:
the reference aggregates and trains in full f32
(``repro/kernels/gossip_mix.py`` accumulates with
``preferred_element_type=f32``), and cuDNN would otherwise run VGG's f32
convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` defaults to
True), which keeps only about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device", "to_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when ``None``/``"cuda"`` is asked for and no GPU is present —
    the caller must ask for ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and no GPU is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``.  On
    the card the copy goes through pinned memory without blocking, so a
    round loop that uploads its host-drawn masks and matrices this way
    never waits for the device (a pageable copy synchronizes)."""
    t = torch.as_tensor(array, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
