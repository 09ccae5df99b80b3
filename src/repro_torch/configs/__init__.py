"""configs of the PyTorch/CUDA port (counterpart of ``repro.configs``)."""
