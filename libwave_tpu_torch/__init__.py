"""PyTorch/CUDA port of libwave_tpu's bundle-adjustment back end.

The package mirrors ``libwave_tpu``'s module paths and public names
(``libwave_tpu_torch.optim.schur`` <-> ``libwave_tpu.optim.schur``) and is
held against it by the parity tests in ``tests/test_torch_*.py``. It imports
``torch`` and never ``jax``: the JAX package stays the reference.

Plain tensor code is PyTorch. The one TPU kernel on the back end's path,
the dense-Schur G/A build, is a CUDA C++ kernel for Hopper
(``csrc/segmm_g_a.cu``), compiled with ``nvcc`` at first use and bound with
``ctypes``; on CPU tensors its plain PyTorch version runs instead.
"""
