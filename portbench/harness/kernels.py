"""The yardstick of the kernels' roofline shares: the chip's peaks, and the
bytes and operations each kernel call needs, counted from its shapes.

The counts follow what the call's inputs need, not what a kernel happens to
read: each input byte the result depends on is read once, each output byte
written once, and where the work depends on the data (a segment's length,
which slots fall in a window) the count is of these inputs. Kernel
redesigns in the program do not move these functions; a kernel whose
contract changes gets a new function beside these.

A call's bound time is the larger of its bytes over the memory bandwidth and
its operations over the arithmetic peak of its dtype; a roofline share is
the sum of the bound times over the sum of the kernels' measured device
times.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, dense rates without
# sparsity, at the full 700 W power limit (a card set lower runs slower:
# the run reports its power limit beside every share).
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {4: 67e12, 8: 34e12},  # float32, float64 (CUDA cores)
}

INDEX_BYTES = 4  # int32 ids and offsets


def seg_reduce(C: int, listed: int, M: int, itemsize: int):
    """``out[c, m] = sum of vals[c, sigma[p]]`` over landmark m's run
    ``offsets[m] <= p < offsets[m + 1]`` (``csrc/segmm_seg.cu``).

    Needs: the ``listed`` slots' values of each channel once (C * listed
    values), their ``listed`` ids in sigma, the M + 1 offsets; writes C * M
    values. Operations: one add per listed value (C * listed).
    Returns (bytes, operations)."""
    nbytes = (C * listed * itemsize + listed * INDEX_BYTES
              + (M + 1) * INDEX_BYTES + C * M * itemsize)
    return nbytes, C * listed


def seg_broadcast(C: int, K: int, used: int, itemsize: int):
    """``out[c, k] = y[c, idx[k]]`` for K slots (``csrc/segmm_seg.cu``).

    Needs: the K ids, each of the ``used`` distinct landmark values of each
    channel once (C * used values); writes C * K values. No arithmetic.
    Returns (bytes, operations)."""
    nbytes = K * INDEX_BYTES + C * used * itemsize + C * K * itemsize
    return nbytes, 0


def g_a(C: int, poses: int, cols: int, slots: int, pairs: int):
    """The dense-Schur G/A build of a window of ``poses`` poses and
    ``cols`` landmark columns (``csrc/segmm_g_a.cu``), float32:
    ``G[n, c, m] = sum of W[c, n, p]`` over pose n's slots in landmark m's
    run, ``A[n, 3d + l, m] = sum_j G[n, 3d + j, m] Hinv_m[j, l]``.

    Needs: the C values and the id of each of the window's ``slots`` once,
    the cols + 1 offsets, the 6 components of each column's Hinv; writes G
    and A whole (2 * poses * C * cols values, zeros included). Operations:
    one add per slot value (C * slots) and, for each of the ``pairs``
    (pose, column) cells that hold a slot, C outputs of three products and
    two adds (5 * C). Returns (bytes, operations)."""
    nbytes = (C * slots * 4 + slots * INDEX_BYTES + (cols + 1) * INDEX_BYTES
              + 6 * cols * 4 + 2 * poses * C * cols * 4)
    return nbytes, C * slots + 5 * C * pairs


def bound_seconds(nbytes: float, ops: float, itemsize: int,
                  peaks: dict = H100_SXM) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the arithmetic peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["flops_per_s"][itemsize])
