"""PyTorch/CUDA port of libwave_tpu: the bundle-adjustment and VIO back
ends, the visual front end, lidar matching, the trajectory back end, the
distributed solvers (``parallel``, over ``torch.distributed``) and the
leaf modules.

The package mirrors ``libwave_tpu``'s module paths and public names
(``libwave_tpu_torch.optim.schur`` <-> ``libwave_tpu.optim.schur``) and is
held against it by the parity tests in ``tests/test_torch_*.py``. It imports
``torch`` and never ``jax``: the JAX package stays the reference.

Plain tensor code is PyTorch. Each TPU kernel on the ported paths is a CUDA
C++ kernel for Hopper: the dense-Schur G/A build (``csrc/segmm_g_a.cu``) and
the Hamming top-2 and table kernels (``csrc/hamming.cu``), compiled with
``nvcc`` at first use and bound with ``ctypes``; on CPU tensors their plain
PyTorch versions run instead.
"""
