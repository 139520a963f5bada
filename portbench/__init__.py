"""Benchmark of the PyTorch and CUDA port (``libwave_tpu_torch``) on one card."""
