"""The benchmark of the PyTorch/CUDA port, varigraph_tpu_torch (see README.md)."""
