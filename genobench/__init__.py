"""The benchmark of the PyTorch and CUDA port (``vargeno_tpu_torch``); see
README.md."""
