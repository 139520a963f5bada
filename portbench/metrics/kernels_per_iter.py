"""kernels_per_iter (kernels/iter): CUDA kernels launched inside the traced
solves, over their LM iterations: the host's launch load per iteration.
Layer: the LM loop (``optim/ba.py``)."""


def read(trace):
    if not trace.kernels or not trace.iterations:
        return None
    return len(trace.kernels) / trace.iterations
