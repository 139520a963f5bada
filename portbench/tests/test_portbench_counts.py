"""The kernels' byte and operation counts, the roofline readers' arithmetic
and the device's busy and idle shares, on synthetic calls and intervals."""

import pytest

from portbench.harness import kernels, spec
from portbench.harness import trace as tr


def test_seg_reduce_counts():
    # C = 3 channels of 10 listed f32 slots, M = 4: 120 + 40 + 20 + 48 B
    assert kernels.seg_reduce(3, 10, 4, 4) == (120 + 40 + 20 + 48, 30)
    assert kernels.seg_reduce(6, 10, 4, 8) == (480 + 40 + 20 + 192, 60)


def test_seg_broadcast_counts():
    # K = 12 ids, 5 distinct landmarks used, C = 3, f32
    assert kernels.seg_broadcast(3, 12, 5, 4) == (48 + 60 + 144, 0)


def test_g_a_counts():
    # 2 poses x 3 columns, C = 18, 4 slots in 4 (pose, column) pairs
    nbytes, ops = kernels.g_a(18, 2, 3, 4, 4)
    assert nbytes == 18 * 4 * 4 + 16 + 16 + 72 + 2 * 2 * 18 * 3 * 4
    assert ops == 18 * 4 + 5 * 18 * 4


def test_bound_takes_the_larger():
    assert kernels.bound_seconds(3.35e12, 0, 4) == pytest.approx(1.0)
    assert kernels.bound_seconds(0, 67e12, 4) == pytest.approx(1.0)
    assert kernels.bound_seconds(0, 34e12, 8) == pytest.approx(1.0)


def test_union_and_idle_gaps():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (90, 120)]
    assert tr.union_ns(iv, 0, 100) == 20 + 10 + 10
    assert tr.idle_gaps(iv, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    assert tr.idle_gaps([], 5, 9) == [(5, 9)]


def _trace(kernel_list, calls=None, windows=((0, 1000),)):
    ops = [(n, s, e) for n, s, e in kernel_list]
    return tr.Trace(windows=list(windows), kernels=ops, device_ops=ops,
                    host_ops=[("cudaLaunchKernel", 0, 1000),
                              ("aten::mul", 490, 510)],
                    solves=[{"iterations": 2, "cg_iterations": [5, 3]}],
                    cg_max_iters=10, calls=calls or {})


def test_idle_share_kernels_and_pcg_readers():
    t = _trace([("k_a", 0, 100), ("k_b", 50, 300), ("k_a", 700, 800)])
    assert t.busy_s == pytest.approx(400e-9)
    assert t.window_s == pytest.approx(1000e-9)
    assert spec.load_reader("device_idle").read(t) == pytest.approx(60.0)
    assert spec.load_reader("kernels_per_iter").read(t) == 1.5
    assert spec.load_reader("pcg_live_share").read(t) == pytest.approx(40.0)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["k_b", pytest.approx(250e-9)]
    assert b["idle_gaps"][0] == ["aten::mul", pytest.approx(400e-9)]


class _Offsets(list):
    """Stands in for an offsets tensor: only its last entry is read."""


def test_roofline_reader_sums_bounds_over_device_time():
    reader = spec.load_reader("seg_reduce_roofline")
    offsets = _Offsets([0, 10, 25, 40])
    key = reader.WATCH[0][:2]
    calls = {key: [(3, 64, 3, 4, offsets), (3, 64, 3, 4, offsets)]}
    nbytes, _ = kernels.seg_reduce(3, 40, 3, 4)
    bound = 2 * nbytes / 3.35e12
    t = _trace([("seg_reduce_sorted_kernel<float>", 0, 100),
                ("seg_reduce_sorted_kernel<float>", 200, 300)], calls)
    assert reader.read(t) == pytest.approx(100.0 * bound / 200e-9)
    # a kernel count that disagrees with the calls reads nothing
    t1 = _trace([("seg_reduce_sorted_kernel<float>", 0, 100)], calls)
    assert reader.read(t1) is None
