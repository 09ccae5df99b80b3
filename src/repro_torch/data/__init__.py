"""data layer of the PyTorch/CUDA port (counterpart of ``repro.data``)."""
