"""serving tier of the PyTorch/CUDA port (counterpart of ``repro.serving``)."""
