"""The reference's studies under ``benchmarks/``, re-run by the port on the
CUDA card with its kernels.

* :mod:`repro_torch.benchmarks.gossip_cost` — the mix-cost study (the
  circulant schedule, the mix backends, n-scaling).
"""
