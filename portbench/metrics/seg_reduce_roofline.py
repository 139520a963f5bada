"""seg_reduce_roofline (%): the segment reduce kernel's share of its
roofline in the traced solves (``ops/segmm.seg_reduce_sorted`` ->
``csrc/segmm_seg.cu``): the sum over its calls of the least time the chip
could take (``portbench.harness.kernels.seg_reduce``, from each call's
shapes) over the kernels' summed device time. Layer: the kernels."""

from portbench.harness import kernels

KERNEL = "seg_reduce_sorted_kernel"


def _call(args):
    vals, offsets = args["vals"], args["offsets"]
    C, K = vals.shape if vals.dim() == 2 else (0, 0)
    return C, K, offsets.shape[0] - 1, vals.element_size(), offsets


WATCH = [("libwave_tpu_torch.ops.segmm", "seg_reduce_sorted", _call)]


def read(trace):
    calls = [c for c in trace.calls.get(WATCH[0][:2], ()) if c[0] and c[2]]
    count, seconds = trace.kernel_seconds(KERNEL)
    if not calls or count != len(calls) or not seconds:
        return None
    listed = {}
    bound = 0.0
    for C, K, M, itemsize, offsets in calls:
        if id(offsets) not in listed:
            listed[id(offsets)] = int(offsets[-1])
        nbytes, ops = kernels.seg_reduce(C, listed[id(offsets)], M, itemsize)
        bound += kernels.bound_seconds(nbytes, ops, itemsize)
    return 100.0 * bound / seconds
