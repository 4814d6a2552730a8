"""Hand-written GPU kernels with their plain PyTorch versions."""
