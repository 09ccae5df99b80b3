"""kernels layer of the PyTorch/CUDA port (counterpart of ``repro.kernels``)."""
