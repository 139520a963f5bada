"""seg_broadcast_roofline (%): the segment broadcast kernels' share of
their roofline in the traced solves (``ops/segmm.seg_broadcast`` ->
``csrc/segmm_seg.cu``, either of its two kernels): the sum over its calls
of the least time the chip could take (``portbench.harness.kernels.
seg_broadcast``, from each call's shapes and its ids' distinct landmarks)
over the kernels' summed device time. Layer: the kernels."""

import torch

from portbench.harness import kernels

KERNEL = "seg_broadcast"


def _call(args):
    y, idx = args["y"], args["idx"]
    C, M = y.shape if y.dim() == 2 else (0, 0)
    return C, idx.shape[0] if idx.dim() == 1 else 0, M, y.element_size(), idx


WATCH = [("libwave_tpu_torch.ops.segmm", "seg_broadcast", _call)]


def read(trace):
    calls = [c for c in trace.calls.get(WATCH[0][:2], ())
             if c[0] and c[1] and c[2]]
    count, seconds = trace.kernel_seconds(KERNEL)
    if not calls or count != len(calls) or not seconds:
        return None
    used = {}
    bound = 0.0
    for C, K, M, itemsize, idx in calls:
        key = (id(idx), M)
        if key not in used:
            ok = idx[(idx >= 0) & (idx < M)]
            used[key] = int(torch.unique(ok).numel())
        nbytes, ops = kernels.seg_broadcast(C, K, used[key], itemsize)
        bound += kernels.bound_seconds(nbytes, ops, itemsize)
    return 100.0 * bound / seconds
