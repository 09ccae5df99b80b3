"""core layer of the PyTorch/CUDA port (counterpart of ``repro.core``)."""
