"""launch entry points of the PyTorch/CUDA port (counterpart of ``repro.launch``)."""
