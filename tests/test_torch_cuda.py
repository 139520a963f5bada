"""Card-only tests of the port: the G/A, segment and Hamming CUDA kernels
against their plain PyTorch versions, their input checks, and small solves
(explicit-S and matrix-free BA, dense and PCG VIO) and a small front-end
sequence through them.

The lidar path has no package kernel: its card tests hold the voxel hash,
the fixed-order segment sums, a batched ICP and the ground segmentation
on the card against the CPU.

The trajectory back end: ``solve_trajectory_gn`` (the GPS/INS smoother at
12 states) and ``lm_solve`` (one curve fit and a vmapped batch) on the card
under sync debug "error", each against the same solve on the CPU (cost
traces rtol 1e-9, states and parameters 1e-9); host inputs (a list datum,
numpy points, a numpy curve fit) landing on the card with ``device=None``;
float ``exact`` against an f64 oracle outside near ties; two k-means builds
with bit-equal centroids (the fixed-order segment reduce, held to its plain
version bit for bit).

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine with the card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

G/A kernel and plain version sum the same f32 terms, only the order of
duplicate-id sums may differ: tolerance 1e-6 * max|plain|, and exact
equality at every cell that takes at most one nonzero slot. The segment
reduce adds in the plain version's order: equal bit for bit, and
bit-identical across runs; the broadcast copies: exact equality. The
Hamming outputs are integers: exact equality. The plain G/A sums duplicate
ids in slot order, pass by pass: bit-identical across runs. A one-rank
NCCL group runs the sharded BA solve to the single-device numbers, bit for
bit. ``utils.trace.profile_trace`` names the segment reduce kernel after
other profiler sessions and a CUDA graph ran in the process.

The matvec kernels: ``wt_slots`` and ``landmark_step`` round each product
and sum as their plain versions do (no FMA): equal bit for bit.
``pose_side`` adds a pose's slots in its own fixed order and forms Hpp x
with FMAs, where the plain version's ``torch.sum`` and ``einsum`` take
others: each adds at most ~50 rounded f32 partial sums in a chain (the
kernel: a thread's slots, 5 shuffle levels, at most 32 warps), so each
lies within ~50 * 2^-24 of the sum of the terms' magnitudes from the
exact value, and the two within 1e-5 of it. All three are bit-identical
across runs.

The preconditioner's self-blocks kernel (``schur_self_blocks``) rounds each
slot's 21 terms as its plain version does and adds a pose's slots in its
own fixed order (a thread's slots, 5 shuffle levels, at most 16 warps),
where the plain version's ``torch.sum`` takes another: each sum is a chain
of at most ~40 rounded additions in either order, so the two agree within
1e-5 of the sum of the terms' magnitudes; bit-identical across runs.

The CG trip kernel (``pcg_trip``) rounds its elementwise steps as the
plain version does and adds its three dots (p . Sp, r . z, r . r) in its
own fixed order, where the plain version's ``torch.sum`` and ``einsum``
take others. Each sum is a chain of at most ~35 rounded additions in
either order (the kernel: 4 elements a thread, 5 shuffle levels, 8 warps,
then up to 4 partials a thread and the same tree again), so each lies
within ~35 * 2^-24 = 2.1e-6 of the sum of its terms' magnitudes from the
exact value; on operands whose sums add terms of one sign (an SPD
operator's p . Sp and r . z, and r . r) that bounds the step sizes'
relative gap by ~4e-6, and x, r, z and p, each a step size times a vector
plus a vector, agree within 1e-5 of their largest magnitude. A frozen
trip leaves x, r and rz bit for bit, and the kernel gives the same bits
run to run.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from libwave_tpu_torch import bench_frontend, bench_problem
from libwave_tpu_torch.ops import _build, hamming, segmm
from libwave_tpu_torch.optim import ba, schur
from libwave_tpu_torch.pipelines import vio, visual_frontend
from libwave_tpu_torch.sim import vo_dataset
from libwave_tpu_torch.utils import precision, trace


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the G/A kernel runs only on the card")
    return torch.device("cuda")


def _inputs(rng, dev, N, P, M, lo, hi):
    W = rng.standard_normal((18, N, P)).astype(np.float32)
    ids = rng.integers(lo, hi, (N, P)).astype(np.int32)
    ids[:, : P // 3] = ids[:, :1]  # duplicates
    ids[0] = -1  # a pose-padding row
    hinv = rng.standard_normal((6, M)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (W, ids, hinv))


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,M,lo,hi", [
    (7, 40, 61, 0, 61),
    (5, 37, 1000, -1, 1003),
    (4, 300, 1024, -250, 1300),
    (3, 700, 257, 0, 257),
])
def test_kernel_matches_plain(cuda_device, N, P, M, lo, hi):
    W, ids, hinv = _inputs(np.random.default_rng(0), cuda_device, N, P, M,
                           lo, hi)
    before = segmm.dense_g_a_window.launches
    G, A = segmm.dense_g_a(W, ids, hinv)
    assert segmm.dense_g_a_window.launches == before + 1
    Gr, Ar = segmm.dense_g_a_reference(W, ids, hinv)
    torch.cuda.synchronize()
    for x, ref in ((G, Gr), (A, Ar)):
        assert float((x - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert not G[0].any() and not A[0].any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    W, ids, hinv = _inputs(np.random.default_rng(1), cuda_device, 3, 16, 20,
                           0, 20)
    with pytest.raises(TypeError):
        segmm.dense_g_a(W.double(), ids, hinv)
    with pytest.raises(TypeError):
        segmm.dense_g_a(W, ids.long(), hinv)
    with pytest.raises(ValueError, match="contiguous"):
        segmm.dense_g_a(W[:, :, ::2], ids[:, ::2], hinv)
    with pytest.raises(ValueError, match="rows"):
        segmm.dense_g_a(W[:9].contiguous(), ids, hinv)
    with pytest.raises(ValueError, match="device"):
        segmm.dense_g_a(W, ids.cpu(), hinv)


@pytest.mark.cuda
def test_small_solve_through_kernel(cuda_device):
    problem, state = bench_problem.make_problem(
        num_poses=20, num_landmarks=500, obs_per_pose=40, device=cuda_device
    )
    cfg = dataclasses.replace(bench_problem.bench_config(3),
                              explicit_s="always")
    cg = cfg.cg_max_iters
    before = segmm.dense_g_a_window.launches
    trips_before = segmm.pcg_trip.launches
    _, info = ba.solve_ba(problem, state, cfg)
    calls = sum(len(r) for _, _, r in problem.bands.entries)
    assert segmm.dense_g_a_window.launches - before == 3 * calls
    with mock.patch.object(schur, "dense_g_a_window",
                           segmm.dense_g_a_window_reference):
        _, info_p = ba.solve_ba(problem, state, cfg)
    # every CG trip of both solves through the trip kernel, one call each
    assert segmm.pcg_trip.launches - trips_before == 6 * cg
    costs, costs_p = info["costs"].cpu().numpy(), info_p["costs"].cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < float(info["initial_cost"])
    np.testing.assert_allclose(costs, costs_p, rtol=1e-3)
    # the plain CG loop on the card: the same first iteration (later ones
    # sit at this small problem's f32 floor, where the dots' order alone
    # moves the cost by a few percent)
    with mock.patch.object(schur, "_takes_fused_cg", return_value=False):
        _, info_c = ba.solve_ba(problem, state, cfg)
    assert segmm.pcg_trip.launches - trips_before == 6 * cg
    np.testing.assert_allclose(costs[0], info_c["costs"].cpu().numpy()[0],
                               rtol=1e-3)


@contextlib.contextmanager
def _tf32_allowed():
    """Let float32 matmuls take TF32, as a careless caller might; restore
    the flags after."""
    mm = torch.backends.cuda.matmul
    if precision._new_api():
        saved = mm.fp32_precision
        mm.fp32_precision = "tf32"
        try:
            yield
        finally:
            mm.fp32_precision = saved
    else:
        saved = mm.allow_tf32
        mm.allow_tf32 = True
        try:
            yield
        finally:
            mm.allow_tf32 = saved


@pytest.mark.cuda
def test_explicit_s_is_full_f32_under_a_tf32_caller(cuda_device):
    """``dense_reduced_system`` on the headline problem's bands and
    ``dense_schur_solve``, called directly with TF32 allowed, equal the
    same calls made under ``full_f32`` bit for bit: both pin full f32
    themselves."""
    problem, state = bench_problem.make_problem(device=cuda_device)
    lam = torch.tensor(1e-4, dtype=state.p.dtype, device=cuda_device)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, lam)
        rhs = schur.schur_rhs(blocks)
        S_ref = schur.dense_reduced_system(blocks, bands=problem.bands)
        x_ref = schur.dense_schur_solve(blocks, rhs)
    with _tf32_allowed():
        assert precision.tf32_enabled()
        S = schur.dense_reduced_system(blocks, bands=problem.bands)
        x = schur.dense_schur_solve(blocks, rhs)
        assert precision.tf32_enabled()
    torch.cuda.synchronize()
    assert torch.equal(S, S_ref)
    assert torch.equal(x, x_ref)


def _assert_g_a_close(G, A, Gr, Ar, single):
    """Within 1e-6 * max|plain|, and equal where ``single`` (cells with at
    most one nonzero slot)."""
    for x, ref in ((G, Gr), (A, Ar)):
        assert float((x - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
        assert torch.equal(x[single], ref[single])


def _nonzero_slots(W, ids, M):
    """(N, 1, M) count of the slots with a nonzero W naming each column."""
    ok = (ids >= 0) & (ids < M) & (W != 0).any(0)
    count = torch.zeros((ids.shape[0], M), dtype=torch.int32, device=W.device)
    count.scatter_add_(1, torch.where(ok, ids, 0).long(), ok.int())
    return count[:, None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(bench_problem.g_a_edge_cases())))
def test_window_kernel_matches_plain(cuda_device, case):
    name, W, ids, hinv, windows = bench_problem.g_a_edge_cases()[case]
    W, ids, hinv = (torch.as_tensor(a, device=cuda_device)
                    for a in (W, ids, hinv))
    M = hinv.shape[1]
    ell = segmm.sorted_layout(ids.reshape(-1), M)
    for c0, c1, plo, phi in windows:
        before = segmm.dense_g_a_window.launches
        G, A = segmm.dense_g_a_window(W, ell, hinv, c0, c1, plo, phi)
        assert segmm.dense_g_a_window.launches == before + 1
        sl = (W[:, plo:phi], ids[plo:phi] - c0, hinv[:, c0:c1])
        Gr, Ar = segmm.dense_g_a_reference(*sl)
        Gw, Aw = segmm.dense_g_a_window_reference(W, ell, hinv, c0, c1, plo,
                                                  phi)
        single = (_nonzero_slots(*sl[:2], c1 - c0) <= 1).expand_as(G)
        torch.cuda.synchronize()
        assert G.shape == (phi - plo, 18, c1 - c0), name
        _assert_g_a_close(G, A, Gr, Ar, single)
        _assert_g_a_close(G, A, Gw, Aw, single)


@pytest.mark.cuda
def test_window_kernel_rejects_what_it_does_not_take(cuda_device):
    W, ids, hinv = _inputs(np.random.default_rng(1), cuda_device, 3, 16, 20,
                           0, 20)
    ell = segmm.sorted_layout(ids.reshape(-1), 20)
    fn = segmm.dense_g_a_window
    with pytest.raises(TypeError):
        fn(W.double(), ell, hinv, 0, 20, 0, 3)
    with pytest.raises(TypeError):
        fn(W, segmm.EllLayout(ell.sigma.long(), ell.offsets), hinv, 0, 20,
           0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fn(W.transpose(1, 2).contiguous().transpose(1, 2), ell, hinv, 0, 20,
           0, 3)
    with pytest.raises(ValueError, match="outside"):
        fn(W, ell, hinv, 0, 21, 0, 3)
    with pytest.raises(ValueError, match="outside"):
        fn(W, ell, hinv, 5, 4, 0, 3)
    with pytest.raises(ValueError, match="outside"):
        fn(W, ell, hinv, 0, 20, 2, 4)
    with pytest.raises(ValueError, match="do not fit"):
        fn(W, segmm.sorted_layout(ids.reshape(-1), 19), hinv, 0, 19, 0, 3)
    with pytest.raises(ValueError, match="device"):
        fn(W, segmm.EllLayout(ell.sigma.cpu(), ell.offsets), hinv, 0, 20,
           0, 3)
    G, A = fn(W, ell, hinv, 4, 4, 0, 3)
    assert G.shape == A.shape == (3, 18, 0)


def _words(rng, dev, n, w):
    a = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    return torch.as_tensor(a.view(np.int32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,w,masked", [
    (512, 512, 16, "some"), (300, 700, 8, "some"), (300, 700, 8, "all"),
    (300, 700, 8, "one"), (129, 257, 4, None), (1, 1, 16, None),
    (1000, 3, 2, "some"), (70, 600, 32, None),
])
def test_hamming_kernels_match_plain(cuda_device, n1, n2, w, masked):
    rng = np.random.default_rng(n1 + n2 + w)
    d2 = _words(rng, cuda_device, n2, w)
    d2[n2 // 2:] = d2[: n2 - n2 // 2].clone()  # duplicate rows: ties
    d1 = torch.cat([d2[: n1 // 3], _words(rng, cuda_device, n1 - n1 // 3, w)])
    mask = None
    if masked == "some":
        mask = torch.as_tensor(rng.random(n2) < 0.7, device=cuda_device)
    elif masked == "all":
        mask = torch.zeros(n2, dtype=torch.bool, device=cuda_device)
    elif masked == "one":
        mask = torch.zeros(n2, dtype=torch.bool, device=cuda_device)
        mask[n2 // 3] = True
    before = (hamming.hamming_top2.launches, hamming.hamming_distance.launches)
    got = hamming.hamming_top2(d1, d2, mask)
    table = hamming.hamming_distance(d1, d2)
    assert (hamming.hamming_top2.launches,
            hamming.hamming_distance.launches) == (before[0] + 1, before[1] + 1)
    ref = hamming.hamming_top2_reference(d1, d2, mask)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert torch.equal(table, hamming.hamming_distance_reference(d1, d2))
    if masked == "all":
        assert (got[0] == hamming.BIG).all() and (got[2] == 0).all()


TOP2_EDGES = bench_frontend.top2_edge_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(TOP2_EDGES)),
                         ids=[c[0] for c in TOP2_EDGES])
def test_top2_kernel_edge_cases(cuda_device, case):
    """Ties across and within the kernel's lanes, the only live column
    last, ragged N2, all masked, the several-rows-per-thread launches: the
    kernel equals its plain version exactly (the CPU tests hold the plain
    version to the Pallas kernel on the same cases)."""
    _, d1, d2, mask = TOP2_EDGES[case]
    a, b = (torch.as_tensor(x.view(np.int32), device=cuda_device)
            for x in (d1, d2))
    m = None if mask is None else torch.as_tensor(mask, device=cuda_device)
    before = hamming.hamming_top2.launches
    got = hamming.hamming_top2(a, b, m)
    assert hamming.hamming_top2.launches == before + 1
    ref = hamming.hamming_top2_reference(a, b, m)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


TABLE_EDGES = bench_frontend.table_edge_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(TABLE_EDGES)),
                         ids=[c[0] for c in TABLE_EDGES])
def test_table_kernel_edge_cases(cuda_device, case):
    """The tensor-core table at every W (1, 2 and 4 pad k with zero words),
    ragged N1 and N2 (partial tiles, scalar stores) and a 2,048-row bank:
    exactly the plain version (the CPU tests hold the plain version to the
    Pallas kernel)."""
    _, d1, d2 = TABLE_EDGES[case]
    a, b = (torch.as_tensor(x.view(np.int32), device=cuda_device)
            for x in (d1, d2))
    before = hamming.hamming_distance.launches
    got = hamming.hamming_distance(a, b)
    assert hamming.hamming_distance.launches == before + 1
    ref = hamming.hamming_distance_reference(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_table_kernel_unaligned_banks(cuda_device):
    """Banks 4 bytes past a 16-byte boundary take the table's 4-byte
    copies."""
    rng = np.random.default_rng(6)
    flat = torch.zeros(700 * 16 + 1, dtype=torch.int32, device=cuda_device)
    view = flat[1:].view(700, 16)
    view.copy_(_words(rng, cuda_device, 700, 16))
    assert view.data_ptr() % 16
    got = hamming.hamming_distance(view[:300], view)
    torch.cuda.synchronize()
    assert torch.equal(got, hamming.hamming_distance_reference(view[:300],
                                                               view))


@pytest.mark.cuda
def test_top2_kernel_unaligned_banks(cuda_device):
    """Banks that start 4 bytes past a 16-byte boundary (contiguous views
    with a storage offset) take the kernel's 4-byte loads."""
    rng = np.random.default_rng(5)

    def unaligned(n):
        flat = torch.zeros(n * 16 + 1, dtype=torch.int32, device=cuda_device)
        view = flat[1:].view(n, 16)
        view.copy_(_words(rng, cuda_device, n, 16))
        return view

    d1, d2 = unaligned(600), unaligned(300)
    d1[:100] = d2[:100]
    assert d1.data_ptr() % 16 and d2.data_ptr() % 16
    got = hamming.hamming_top2(d1, d2)
    ref = hamming.hamming_top2_reference(d1, d2)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_hamming_kernels_reject_what_they_do_not_take(cuda_device):
    rng = np.random.default_rng(1)
    d1, d2 = _words(rng, cuda_device, 8, 16), _words(rng, cuda_device, 9, 16)
    mask = torch.ones(9, dtype=torch.bool, device=cuda_device)
    for fn, extra in ((hamming.hamming_top2, (mask,)),
                      (hamming.hamming_distance, ())):
        with pytest.raises(TypeError):
            fn(d1.long(), d2, *extra)
        with pytest.raises(ValueError, match="device"):
            fn(d1, d2.cpu(), *extra)
        with pytest.raises(ValueError, match="contiguous"):
            fn(d1[:, ::2], d2[:, ::2], *extra)
        with pytest.raises(ValueError, match="built for W"):
            fn(d1[:, :3].contiguous(), d2[:, :3].contiguous(), *extra)
        with pytest.raises(ValueError):
            fn(d1, d2[:, :8].contiguous(), *extra)
    with pytest.raises(ValueError, match="mask2"):
        hamming.hamming_top2(d1, d2, mask.int())


@pytest.mark.cuda
def test_small_sequence_through_top2_kernel(cuda_device):
    p = bench_frontend.EurocSimParams(
        duration=1.6, nb_landmarks=120, fx=229.0, fy=228.0, cx=188.0,
        cy=120.0, width=376, height_px=240,
    )
    frames = bench_frontend.make_euroc_frames(p, seed=0)
    before = hamming.hamming_top2.launches
    tracks = visual_frontend.track_sequence(frames, device=cuda_device)
    assert hamming.hamming_top2.launches - before == len(frames)
    with mock.patch.object(hamming, "hamming_top2",
                           hamming.hamming_top2_reference):
        tracks_p = visual_frontend.track_sequence(frames, device=cuda_device)
    np.testing.assert_array_equal(tracks, tracks_p)
    cpu = visual_frontend.track_sequence(frames, device="cpu")
    assert abs(len(tracks) - len(cpu)) <= 0.1 * max(len(tracks), len(cpu))
    assert len(tracks) >= 60


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,M,dtype", [
    (3, 60_000, 10_000, torch.float32), (6, 60_000, 10_000, torch.float32),
    (1, 12_345, 777, torch.float32), (3, 5_001, 300, torch.float64),
    (6, 1_000, 4_000, torch.float64), (6, 60_000, 500, torch.float64),
    (2, 7_777, 50, torch.float32), (5, 3_000, 100, torch.float64),
])
def test_segment_kernels_match_plain(cuda_device, C, K, M, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(K + M)
    idx = torch.randint(-3, M + 3, (K,), generator=gen, dtype=torch.int32,
                        device=cuda_device)  # ids < 0 and >= M
    idx[: K // 10] = M // 2  # a long run; M > K leaves most segments empty
    vals = torch.randn((C, K), generator=gen, dtype=dtype, device=cuda_device)
    y = torch.randn((C, M), generator=gen, dtype=dtype, device=cuda_device)
    sigma, offsets = segmm.sorted_layout(idx, M)
    before = (segmm.seg_reduce_sorted.launches, segmm.seg_broadcast.launches)
    out = segmm.seg_reduce_sorted(vals, sigma, offsets)
    again = segmm.seg_reduce(vals, idx, M)
    got = segmm.seg_broadcast(y, idx)
    assert (segmm.seg_reduce_sorted.launches,
            segmm.seg_broadcast.launches) == (before[0] + 2, before[1] + 1)
    ref = segmm.seg_reduce_sorted_reference(vals, sigma, offsets)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, again)
    assert torch.equal(out, ref)
    assert torch.equal(got, segmm.seg_broadcast_reference(y, idx))
    ok = (idx >= 0) & (idx < M)
    assert not got[:, ~ok].any()


BROADCAST_EDGES = bench_problem.broadcast_edge_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", range(len(BROADCAST_EDGES)),
                         ids=[c[0] for c in BROADCAST_EDGES])
def test_broadcast_kernel_edge_cases(cuda_device, case, dtype):
    """K % 4 != 0 and ids with a storage offset of 1 (the kernel's scalar
    path), C = 1, 3, 5, 6, and a y past 384 KB (one channel at a time):
    exact equality with the plain version."""
    _, y, ids, off = BROADCAST_EDGES[case]
    yt = torch.as_tensor(y, device=cuda_device).to(dtype)
    idx = torch.as_tensor(ids, device=cuda_device)[off:]
    before = segmm.seg_broadcast.launches
    got = segmm.seg_broadcast(yt, idx)
    assert segmm.seg_broadcast.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, segmm.seg_broadcast_reference(yt, idx))


@pytest.mark.cuda
def test_segment_kernels_reject_what_they_do_not_take(cuda_device):
    idx = torch.randint(0, 10, (100,), dtype=torch.int32, device=cuda_device)
    vals = torch.randn((3, 100), device=cuda_device)
    y = torch.randn((3, 10), device=cuda_device)
    sigma, offsets = segmm.sorted_layout(idx, 10)
    red, bc = segmm.seg_reduce_sorted, segmm.seg_broadcast
    with pytest.raises(TypeError):
        red(vals.half(), sigma, offsets)
    with pytest.raises(TypeError):
        red(vals, sigma.long(), offsets)
    with pytest.raises(ValueError, match="device"):
        red(vals, sigma.cpu(), offsets)
    with pytest.raises(ValueError, match="contiguous"):
        red(torch.randn((100, 3), device=cuda_device).T, sigma, offsets)
    with pytest.raises(ValueError, match="do not fit"):
        red(vals, sigma[:50].contiguous(), offsets)
    with pytest.raises(TypeError):
        bc(y.half(), idx)
    with pytest.raises(TypeError):
        bc(y, idx.long())
    with pytest.raises(ValueError, match="device"):
        bc(y, idx.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        bc(torch.randn((10, 3), device=cuda_device).T, idx)
    with pytest.raises(ValueError, match="2-D"):
        bc(y[0], idx)


def _launches():
    return (segmm.dense_g_a_window.launches, segmm.seg_reduce_sorted.launches,
            segmm.seg_broadcast.launches)


def _matvec_launches():
    return (segmm.matvec_wt_slots.launches,
            segmm.matvec_landmark_step.launches,
            segmm.matvec_pose_side.launches)


def _plain_crossings():
    return mock.patch.multiple(
        segmm, seg_reduce_sorted=segmm.seg_reduce_sorted_reference,
        seg_broadcast=segmm.seg_broadcast_reference)


@pytest.mark.cuda
def test_small_matrix_free_solve_through_segment_kernels(cuda_device):
    problem, state = bench_problem.make_problem(
        num_poses=20, num_landmarks=500, obs_per_pose=40, device=cuda_device
    )
    cfg = dataclasses.replace(bench_problem.bench_config(3),
                              explicit_s="never")
    cg = cfg.cg_max_iters
    before, mv_before = _launches(), _matvec_launches()
    trips_before = segmm.pcg_trip.launches
    self_before = segmm.schur_self_blocks.launches
    _, info = ba.solve_ba(problem, state, cfg)
    # per LM iteration: Hll, bl, back-substitution and one reduce per CG
    # step; schur_rhs's broadcast and the preconditioner's self-blocks
    # kernel, which gathers Hll^-1 itself; each CG step's matvec also W^T x,
    # the Hll^-1 step and the pose side, which gathers y itself
    grew = tuple(a - b for a, b in zip(_launches(), before))
    assert grew == (0, 3 * (3 + cg), 3 * 1)
    assert segmm.schur_self_blocks.launches - self_before == 3
    assert tuple(a - b for a, b in zip(_matvec_launches(), mv_before)) == (
        3 * cg,) * 3
    with _plain_crossings():
        _, info_p = ba.solve_ba(problem, state, cfg)
    assert _launches()[1:] == (before[1] + 3 * (3 + cg), before[2] + 3 * 1)
    assert _matvec_launches() == tuple(b + 6 * cg for b in mv_before)
    assert segmm.schur_self_blocks.launches - self_before == 6
    # every CG trip of both solves through the trip kernel, one call each
    assert segmm.pcg_trip.launches - trips_before == 6 * cg
    costs, costs_p = info["costs"].cpu().numpy(), info_p["costs"].cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < float(info["initial_cost"])
    np.testing.assert_allclose(costs, costs_p, rtol=1e-3)
    # the plain CG loop on the card: the same first iteration as the trip
    # kernel's loop (later ones sit at this small problem's f32 floor,
    # where the dots' order alone moves the cost by a few percent). Both
    # loops take the plain self-blocks here: this problem's f32 CG lies
    # 0.1-3.8% from f64's in the first cost (seeds 0-3), whatever the
    # preconditioner, and the self-blocks kernel's rounding, as close to
    # f64 as the plain sweep's, moves the two loops' first costs 0.5% apart
    # on this seed (test_pcg_with_the_fused_preconditioner holds the kernel
    # to f64)
    with mock.patch.object(segmm, "takes_self_blocks", return_value=False):
        _, info_f = ba.solve_ba(problem, state, cfg)
        with mock.patch.object(schur, "_takes_fused_cg",
                               return_value=False):
            _, info_c = ba.solve_ba(problem, state, cfg)
    assert segmm.pcg_trip.launches - trips_before == 9 * cg
    np.testing.assert_allclose(info_f["costs"].cpu().numpy()[0],
                               info_c["costs"].cpu().numpy()[0], rtol=1e-3)
    # the fused matvec is as accurate as the plain one: each f32 matvec's
    # distance from the f64 one, within 2x the plain one's (or 2^-24)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, torch.tensor(
            cfg.init_lambda, device=cuda_device))
    x = torch.randn(blocks.bp.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    err = bench_problem.matvec_error(blocks, x)
    assert err["fused"] <= 2 * err["plain"] + 2.0**-24, err


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,M,D,free_cols,strided",
                         bench_problem.MATVEC_CASES)
def test_matvec_kernels_match_plain(cuda_device, N, P, M, D, free_cols,
                                    strided):
    """Each matvec kernel against its plain version (module docstring:
    ``wt_slots`` and ``landmark_step`` bit for bit, ``pose_side`` within
    1e-5 of the sum of its terms' magnitudes, exact zeros on fixed
    coordinates), one launch each, and the same bits on a second run."""
    a = bench_problem.matvec_operands(N, P, M, D, free_cols, strided,
                                      device=cuda_device)
    if strided:
        assert a["W"].stride(0) == 3 * N * P and not a["W"].is_contiguous()
    before = _matvec_launches()
    err = bench_problem.matvec_kernel_errors(a)
    assert _matvec_launches() == tuple(b + 2 for b in before)
    assert err["same_bits"] and err["fixed_zero"], err
    assert err["wt_slots"]["equal"] and err["landmark_step"]["equal"], err
    assert err["pose_side"]["rel"] <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("N,P,M,strided,sequential",
                         bench_problem.SELF_BLOCKS_CASES)
def test_self_blocks_kernel_matches_plain(cuda_device, N, P, M, strided,
                                          sequential):
    """The preconditioner's self-blocks kernel against its plain version
    (module docstring: within 1e-5 of the sum of its terms' magnitudes),
    both triangles equal, one launch a call and the same bits on a second
    run: both block widths (Pmax up to 512 and above), padding slots and
    ids < 0 and >= M, a strided window view of a union's W, a sequential
    capture's ids and venice-mf's whole shape."""
    a = bench_problem.self_blocks_operands(N, P, M, strided, sequential,
                                           device=cuda_device)
    if strided:
        assert not a["W"].is_contiguous()
    before = segmm.schur_self_blocks.launches
    err = bench_problem.self_blocks_errors(a)
    assert segmm.schur_self_blocks.launches - before == 2
    assert err["same_bits"] and err["symmetric"], err
    assert err["rel"] <= 1e-5, err


@pytest.mark.cuda
def test_pcg_with_the_fused_preconditioner(cuda_device):
    """``schur.pcg`` at a small problem's first linearization takes the
    self-blocks kernel once (``schur.precond_fused``) and is as accurate as
    the solve with the plain self-blocks: the same CG iterations, and its x
    within 2x the plain one's distance from the f64 solve of the same
    blocks (relative 2-norm; the fused solves' rule in chip_smoke.py's
    witness). This problem's 20 f32 CG steps lie ~10% from f64's, and any
    rounding of the operator moves them by ~0.2%: the two f32 solves are
    held to f64, not to each other."""
    problem, state = bench_problem.make_problem(
        num_poses=20, num_landmarks=500, obs_per_pose=40, device=cuda_device)
    cfg = bench_problem.bench_config(3)
    with precision.full_f32():
        blocks = ba._linearize_ba(problem, state, torch.tensor(
            cfg.init_lambda, device=cuda_device))
    rhs = schur.schur_rhs(blocks).contiguous()
    before = segmm.schur_self_blocks.launches
    with trace.recording() as rec:
        cg = schur.pcg(blocks, rhs, cfg.cg_max_iters, cfg.cg_tol)
    assert rec.counters["schur.precond_fused"] == 1
    assert segmm.schur_self_blocks.launches - before == 1
    with mock.patch.object(segmm, "takes_self_blocks", return_value=False):
        cg_p = schur.pcg(blocks, rhs, cfg.cg_max_iters, cfg.cg_tol)
    assert segmm.schur_self_blocks.launches - before == 1
    wide = blocks._replace(**{f: getattr(blocks, f).double() for f in (
        "Hpp", "Hll_inv", "W", "bp", "bl", "free_pose", "C")})
    x64 = schur.pcg(wide, schur.schur_rhs(wide).contiguous(),
                    cfg.cg_max_iters, cfg.cg_tol).x
    assert segmm.schur_self_blocks.launches - before == 1

    def gap(x):
        return float((x.double() - x64).norm() / x64.norm())

    assert int(cg.iterations) == int(cg_p.iterations)
    assert gap(cg.x) <= 2 * gap(cg_p.x), (gap(cg.x), gap(cg_p.x))


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,free_cols", bench_problem.PCG_TRIP_CASES)
def test_pcg_trip_kernel_matches_plain(cuda_device, N, D, free_cols):
    """The CG trip kernel against its plain version at venice-mf's and
    final-13682-mf's pose counts, D = 6 and 15 (module docstring: x, r, z,
    p, rz and rr within 1e-5 of their largest magnitude), a live trip
    counting one more iteration and a frozen one leaving x, r and rz bit
    for bit and the count as it was, exact zeros on fixed coordinates, the
    same bits on a second run, one counted call a trip."""
    a = bench_problem.pcg_trip_operands(N, D, free_cols, device=cuda_device)
    before = segmm.pcg_trip.launches
    err = bench_problem.pcg_trip_errors(a)
    assert segmm.pcg_trip.launches - before == 4
    assert err["it_equal"] and err["same_bits"], err
    assert err["frozen_kept"] and err["fixed_zero"], err
    for k in ("rel", "rel_frozen"):
        assert max(err[k].values()) <= 1e-5, err


@pytest.mark.cuda
def test_pcg_trip_raises_on_the_card(cuda_device):
    """On the card ``pcg_trip`` raises on an operand the kernel does not
    take, checks each trip's Sp, and raises when the card refuses a
    launch (the library's error code stood in by a fake library)."""
    a = bench_problem.pcg_trip_operands(50, 6, False, device=cuda_device)
    x, r, p = a["x"].clone(), a["r"].clone(), a["p"].clone()
    z = torch.empty_like(x)
    state = torch.stack([a["rz"], a["rr"], a["rr"], torch.zeros_like(a["rz"])])
    with pytest.raises(ValueError, match="distinct"):
        segmm.pcg_trip(a["P"], a["free"], x, r, x, p, state)
    with pytest.raises(ValueError, match="device"):
        segmm.pcg_trip(a["P"].cpu(), a["free"], x, r, z, p, state)
    trip = segmm.pcg_trip(a["P"], a["free"], x, r, z, p, state)
    for bad in (a["Sp"].double(), a["Sp"][:10], a["Sp"].T.contiguous().T,
                a["Sp"].cpu(), p):
        with pytest.raises(ValueError, match="Sp must be"):
            trip(bad)
    lib, log = _build.load(segmm._PCG_LIB)
    fake = mock.Mock(pcg_trip_f32=mock.Mock(return_value=9),
                     pcg_trip_scratch_floats=lib.pcg_trip_scratch_floats)
    before = segmm.pcg_trip.launches
    with mock.patch.object(_build, "load", return_value=(fake, log)):
        trip = segmm.pcg_trip(a["P"], a["free"], x, r, z, p, state)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        trip(a["Sp"])
    assert segmm.pcg_trip.launches == before


@pytest.mark.cuda
def test_small_vio_solve_through_kernels(cuda_device):
    """f64 VIO (9 keyframes, 30 landmarks) on the card against the CPU: PCG
    through the segment kernels to rtol 1e-9; the dense path builds G/A in
    f32 on the card (the kernel's contract) and f64 on the CPU: rtol 1e-2."""
    params = vo_dataset.VoSimParams(nb_landmarks=30, steps=100, hz=10.0,
                                    fx=200.0, fy=200.0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ds = vo_dataset.generate_vo_dataset(params, seed=2, device=dev)
        problem, gt = vio.vio_from_sim(ds, device=dev)
        rng = np.random.default_rng(3)
        init = gt._replace(
            p=gt.p + torch.as_tensor(0.03 * rng.normal(size=gt.p.shape),
                                     device=dev),
            lm=gt.lm + torch.as_tensor(0.2 * rng.normal(size=gt.lm.shape),
                                       device=dev),
        )
        for solver in ("auto", "pcg"):
            cfg = vio.VIOConfig(max_iterations=4, cg_max_iters=30,
                                solver=solver)
            before = _launches()
            _, info = vio.solve_vio(problem, init, cfg)
            grew = tuple(a - b for a, b in zip(_launches(), before))
            out[dev.type, solver] = (float(info["initial_cost"]),
                                     float(info["final_cost"]), grew)
    for solver, want in (("auto", (4, 12, 4)), ("pcg", (0, 4 * 33, 4 * 32))):
        c0, c, grew = out["cuda", solver]
        c0_cpu, c_cpu, grew_cpu = out["cpu", solver]
        assert grew == want and grew_cpu == (0, 0, 0)
        assert np.isfinite(c) and c < c0
        np.testing.assert_allclose(c0, c0_cpu, rtol=1e-12)
        np.testing.assert_allclose(c, c_cpu,
                                   rtol=1e-2 if solver == "auto" else 1e-9)


@pytest.mark.cuda
def test_small_euroc_vio_through_kernels(cuda_device, tmp_path):
    """A 3 s EuRoC sequence (16 keyframes) written, built and solved on the
    card in f32 (the dense path: 1 G/A, 3 reduces, 1 broadcast per LM
    iteration) against the same build and solve on the CPU: final cost
    within rtol 1e-3 and keyframe positions within 1 mm (after 5 iterations
    the final cost is about 24, and the card and CPU solves part by 1.9e-4
    in it; chip_smoke.py's 25-iteration solve of the full sequence parts by
    5.7e-6 and is held to rtol 1e-4)."""
    from libwave_tpu_torch.pipelines import euroc_vio
    from libwave_tpu_torch.sim import euroc_sim

    root = str(tmp_path)
    euroc_sim.generate_euroc_sequence(
        root, euroc_sim.EurocSimParams(duration=3.0, nb_landmarks=40),
        seed=3, device=cuda_device)
    cfg = dataclasses.replace(
        euroc_vio.default_vio_config(euroc_vio.EurocVIOParams()),
        max_iterations=5)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = _launches()
        state, rep = euroc_vio.run_euroc_vio(root, cfg=cfg, device=dev)
        grew = tuple(a - b for a, b in zip(_launches(), before))
        out[dev.type] = (state, rep, grew)
    (st, rep, grew), (st_c, rep_c, grew_c) = out["cuda"], out["cpu"]
    assert grew == (5, 15, 5) and grew_c == (0, 0, 0)
    assert st.q.dtype == torch.float32 and rep["num_keyframes"] == 16
    assert np.isfinite(rep["final_cost"])
    assert rep["final_cost"] < rep["initial_cost"]
    assert rep["ate_rmse"] < rep["ate_rmse_deadreckon"]
    rel = abs(rep["final_cost"] / rep_c["final_cost"] - 1)
    dp = float((st.p.cpu() - st_c.p).abs().max())
    print(f"card vs CPU: final cost relative difference {rel:.3e}, keyframe "
          f"positions within {dp:.3e} m")
    assert rel <= 1e-3 and dp <= 1e-3, (rel, dp)


@pytest.mark.cuda
def test_small_windowed_vio_through_kernels(cuda_device, tmp_path):
    """A 40 s sequence at 5 Hz (201 keyframes, 200 landmarks, written with
    a CPU generator) through the windowed solver at euroc_long's ``window=
    80, overlap=10``: 3 windows of one 36-iteration chunk each, f32, the
    Schur complements on the card. Launches: 1 G/A, 3 reduces, 1 broadcast
    per LM iteration and 1, 2, 1 per complement (2 of them). The same run
    on the CPU through the plain versions: window costs within rtol 1e-4
    and keyframe positions within 1 mm, chip_smoke.py's bounds for the
    first windows of euroc_long (this problem's own f32 and f64 CPU solves
    part by 4.2e-6 and 6.8e-5 m). One chunk a window, so the chunk stop
    rule cannot stop the two at different iterations. Windows of 20
    keyframes were tried first: their f32 solves follow the rounding
    (card and CPU parted by 9.9e-4 in cost and 2.2 cm, the CPU's own f32
    and f64 solves by 2.1e-4 and 6.6 mm)."""
    from libwave_tpu_torch.pipelines import euroc_vio, windowed_vio
    from libwave_tpu_torch.sim import euroc_sim

    root = str(tmp_path)
    euroc_sim.generate_euroc_sequence(
        root, euroc_sim.EurocSimParams(duration=40.0, cam_hz=5.0,
                                       nb_landmarks=200),
        seed=0, device="cpu")
    params = euroc_vio.EurocVIOParams()
    wp = windowed_vio.WindowedVIOParams(window=80, overlap=10,
                                        solve_iters_chunk=36,
                                        solve_chunks_max=1)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = _launches()
        est, rep = windowed_vio.run_euroc_vio_windowed(root, params, wp,
                                                       device=dev)
        out[dev.type] = (est, rep, tuple(
            a - b for a, b in zip(_launches(), before)))
    (est, rep, grew), (est_c, rep_c, grew_c) = out["cuda"], out["cpu"]
    it = sum(rep["window_iterations"])
    assert rep["num_windows"] == 3 and rep["marg_host_fallbacks"] == 0
    assert rep["window_iterations"] == rep_c["window_iterations"] == [36] * 3
    assert grew == (it + 2, 3 * it + 4, it + 2) and grew_c == (0, 0, 0)
    costs, costs_c = (np.asarray(r["window_final_costs"])
                      for r in (rep, rep_c))
    dp = float((est.poses.t - est_c.poses.t).abs().max())
    print(f"card vs CPU: window costs within "
          f"{np.abs(costs / costs_c - 1).max():.3e}, positions within "
          f"{dp:.3e} m; iterations {rep['window_iterations']} vs "
          f"{rep_c['window_iterations']}")
    np.testing.assert_allclose(costs, costs_c, rtol=1e-4)
    assert dp <= 1e-3 and rep["ate_rmse"] < 0.05


@pytest.mark.cuda
def test_small_windowed_ba_through_kernels(cuda_device):
    """``bench_problem.windowed_ba_circle`` at 400 steps (36 frames, 60
    landmarks) through ``solve_ba_windowed`` at ``window=15, overlap=4``
    (3 windows of 10 LM iterations, explicit-S PCG, f32): 1 G/A, 3
    reduces, 1 broadcast per iteration and 1, 2, 1 per reduced Hessian (2).
    The same on the CPU through the plain versions with explicit S forced
    (the card's "auto" choice): window costs within rtol 1e-4, positions
    within 1 mm."""
    from libwave_tpu_torch.optim.pose_graph import BetweenBank, PriorBank
    from libwave_tpu_torch.pipelines import windowed_ba

    c = bench_problem.windowed_ba_circle(vo_dataset.VoSimParams(
        nb_landmarks=60, steps=400, fx=200.0, fy=200.0, hz=10.0))
    cfg = ba.BAConfig(max_iterations=10, cg_max_iters=150, huber_delta=3.0)
    out = {}
    for dev, cf in ((cuda_device, cfg), (torch.device("cpu"),
                    dataclasses.replace(cfg, explicit_s="always"))):
        before = _launches()
        q, p, rep = windowed_ba.solve_ba_windowed(
            c["K"], c["tracks"], c["num_frames"], c["q_init"], c["p_init"],
            between=BetweenBank(**{k: torch.as_tensor(v, device=dev)
                                   for k, v in c["between"].items()}),
            priors=PriorBank(**{k: torch.as_tensor(v, device=dev)
                                for k, v in c["priors"].items()}),
            wparams=windowed_ba.WindowedBAParams(window=15, overlap=4),
            cfg=cf, device=dev)
        out[dev.type] = (p, rep, tuple(
            a - b for a, b in zip(_launches(), before)))
    (p, rep, grew), (p_c, rep_c, grew_c) = out["cuda"], out["cpu"]
    assert rep["num_windows"] == 3
    assert grew == (32, 94, 32) and grew_c == (0, 0, 0)
    np.testing.assert_allclose(rep["window_final_costs"],
                               rep_c["window_final_costs"], rtol=1e-4)
    assert float(np.abs(p - p_c).max()) <= 1e-3
    assert float(np.linalg.norm(p - c["p_gt"], axis=-1).max()) < 0.1


# --- the lidar path: no package kernel, card against CPU -------------------


def _lidar_cloud(seed, n=2048, dtype=torch.float32):
    from libwave_tpu_torch.matching import synthetic_scan

    return synthetic_scan(seed, n=n, dtype=dtype, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [0.05, 0.3, 2.0])
def test_voxel_hash_bits_card_vs_cpu(cuda_device, leaf):
    """The int32 voxel hash on the card equals the CPU's bit for bit (the
    division by the leaf is exact on both; the products wrap)."""
    from libwave_tpu_torch.matching.pointcloud import _voxel_hash

    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.float64):
        pts = torch.as_tensor(rng.uniform(-5e3, 5e3, (4096, 3))).to(dtype)
        assert torch.equal(_voxel_hash(pts.to(cuda_device), leaf).cpu(),
                           _voxel_hash(pts, leaf))


@pytest.mark.cuda
def test_voxel_and_ndt_sums_repeat_bit_for_bit(cuda_device):
    """voxel_downsample's and build_ndt_grid's segment sums give the same
    bits on two card runs (no atomics), and agree with the CPU: the same
    masks and keys, means within 1e-5 m (f32)."""
    from libwave_tpu_torch.matching import PointCloud, voxel_downsample
    from libwave_tpu_torch.matching.ndt import build_ndt_grid

    cpu = _lidar_cloud(3, n=4096)
    card = PointCloud(*(x.to(cuda_device) for x in cpu))
    runs = ((lambda c: voxel_downsample(c, 0.3), "mask", "points"),
            (lambda c: build_ndt_grid(c, 2.0), "keys", "means"))
    for fn, exact, close in runs:
        a, b, ref = fn(card), fn(card), fn(cpu)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert torch.equal(getattr(a, exact).cpu(), getattr(ref, exact))
        np.testing.assert_allclose(getattr(a, close).cpu().numpy(),
                                   getattr(ref, close).numpy(), atol=1e-5)


@pytest.mark.cuda
def test_batched_icp_equals_pairs_one_at_a_time(cuda_device):
    """Three pairs through one batched multiscale icp_match on the card, at
    f64, against the same pairs one at a time on the card (iterations
    equal, transforms within 1e-9) and against the CPU (1e-9)."""
    from libwave_tpu_torch.geometry import so3
    from libwave_tpu_torch.geometry.se3 import SE3
    from libwave_tpu_torch.matching import (
        ICPParams,
        PointCloud,
        icp_match,
        transform_cloud,
    )

    ref = _lidar_cloud(11, n=2048, dtype=torch.float64)
    tgts = [transform_cloud(SE3(
        q=so3.exp_quat(torch.tensor([0.0, 0.0, 0.01 * k],
                                    dtype=torch.float64)),
        t=torch.tensor([0.1 * k, 0.05, 0.0], dtype=torch.float64)), ref)
        for k in range(3)]
    params = ICPParams(res=0.2, multiscale_steps=2, max_iter=25)

    def stack(clouds, dev):
        return PointCloud(torch.stack([c.points for c in clouds]).to(dev),
                          torch.stack([c.mask for c in clouds]).to(dev))

    batched = icp_match(stack([ref] * 3, cuda_device),
                        stack(tgts, cuda_device), params)
    for k, tgt in enumerate(tgts):
        for dev in (cuda_device, torch.device("cpu")):
            one = icp_match(PointCloud(*(x.to(dev) for x in ref)),
                            PointCloud(*(x.to(dev) for x in tgt)), params)
            assert int(one.iterations) == int(batched.iterations[k])
            for a, b in zip(one.transform, batched.transform):
                np.testing.assert_allclose(a.cpu().numpy(),
                                           b[k].cpu().numpy(), atol=1e-9)


@pytest.mark.cuda
def test_segment_ground_card_vs_cpu(cuda_device):
    """segment_ground on the card against the CPU on the JAX package
    test's scene size at 24 x 40 bins and at the default bins: labels agree
    on at least 99.9% of points (f32)."""
    from libwave_tpu_torch import bench_lidar
    from libwave_tpu_torch.matching import (
        GroundSegmentationParams,
        make_cloud,
        segment_ground,
    )

    pts, _ = bench_lidar.ground_scene(12000, 2000, 600)
    for params in (GroundSegmentationParams(rmax=60.0, num_bins_a=24,
                                            num_bins_l=40),
                   GroundSegmentationParams()):
        card = segment_ground(make_cloud(pts, device=cuda_device), params)
        cpu = segment_ground(make_cloud(pts, device="cpu"), params)
        agree = (card.labels.cpu() == cpu.labels).double().mean()
        assert float(agree) >= 0.999


@contextlib.contextmanager
def _no_sync():
    """Sync debug mode "error": a synchronizing call in the body raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_identity_and_matrix_make_no_sync(cuda_device):
    """``so3.quat_identity`` and ``SE3.matrix`` wrote a host scalar into a
    card tensor, a synchronizing copy on every ICP trip; now neither
    synchronizes (sync debug mode "error" raises on one)."""
    from libwave_tpu_torch.geometry.se3 import SE3

    with _no_sync():
        T = SE3.identity((5,), device=cuda_device)
        M = T.matrix()
    assert torch.equal(M.cpu(), torch.eye(4).expand(5, 4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(512, 512), (300, 700), (37, 1500)])
def test_top2_kernel_at_orb_width(cuda_device, n1, n2):
    """ORB's 256-bit rBRIEF banks are W = 8 words: the top-2 kernel equals
    its plain version exactly there, masked and ragged."""
    rng = np.random.default_rng(n1)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint64).astype(np.uint32)
    d1 = d2[rng.integers(0, n2, n1)].copy()
    d1[::3] ^= np.uint32(1) << np.uint32(9)
    mask = rng.random(n2) < 0.8
    a, b = (torch.as_tensor(x.view(np.int32), device=cuda_device)
            for x in (d1, d2))
    m = torch.as_tensor(mask, device=cuda_device)
    got = hamming.hamming_top2(a, b, m)
    ref = hamming.hamming_top2_reference(a, b, m)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_orb_frame_card_against_cpu(cuda_device):
    """One 752x480 frame through ``method="orb"`` on the card and on the
    CPU: keypoints by set overlap >= 99%, rBRIEF bits of the shared ones
    >= 99% equal (the pyramid's f32 contractions round differently in
    cuBLAS and on the CPU), 8-word banks; a tracked 4-frame sequence
    launches the top-2 kernel once a frame."""
    frames = bench_frontend.make_euroc_frames(
        bench_frontend.EurocSimParams(duration=0.6, cam_hz=5.0,
                                      nb_landmarks=400), seed=0)
    orb = visual_frontend.FrontendParams(method="orb")
    banks = [visual_frontend.detect_and_describe(
        torch.as_tensor(frames[2], device=d), orb)
        for d in (cuda_device, "cpu")]
    rows = [{tuple(p): w for p, w, m in zip(
        xy.cpu().numpy(), desc.cpu().numpy(), mask.cpu().numpy()) if m}
        for xy, desc, mask in banks]
    shared = sorted(set(rows[0]) & set(rows[1]))
    assert len(shared) >= 0.99 * max(len(rows[0]), len(rows[1])) > 100
    bits = [np.unpackbits(np.stack([r[k] for k in shared]).view(np.uint8),
                          axis=1) for r in rows]
    assert (bits[0] == bits[1]).mean() >= 0.99
    assert banks[0][1].shape == (512, 8)
    before = hamming.hamming_top2.launches
    tracks = visual_frontend.track_sequence(frames[:4], params=orb,
                                            device=cuda_device)
    assert hamming.hamming_top2.launches - before == 4 and len(tracks) > 0


@pytest.mark.cuda
def test_png_round_trip_of_a_card_written_sequence(cuda_device, tmp_path):
    """The simulator run on the card writes cam0 PNGs with the package's own
    encoder; they decode to ``cam0_frames`` bit for bit, and the images
    entry point runs from them on the card."""
    from libwave_tpu_torch.pipelines import euroc_vio
    from libwave_tpu_torch.sim import euroc_sim
    from libwave_tpu_torch.vision import images

    sim = euroc_sim.EurocSimParams(
        duration=3.0, cam_hz=5.0, nb_landmarks=120, fx=229.0, fy=228.0,
        cx=188.0, cy=120.0, width=376, height_px=240, render_images=True)
    euroc_sim.generate_euroc_sequence(str(tmp_path), sim, seed=0,
                                      device=cuda_device)
    got = images.read_image_sequence(
        str(tmp_path / "mav0" / "cam0" / "data"))
    np.testing.assert_array_equal(got, euroc_sim.cam0_frames(sim, seed=0))
    K = np.array([[sim.fx, 0, sim.cx], [0, sim.fy, sim.cy], [0, 0, 1.0]])
    _, rep = euroc_vio.run_euroc_vio_from_images(
        str(tmp_path), euroc_vio.EurocVIOParams(), K=K, device=cuda_device)
    assert np.isfinite(rep["ate_rmse"]) and rep["num_tracks"] >= 30
    assert rep["frontend_frames"] == len(got)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fast_brisk", "orb"])
def test_batched_tracking_equals_single_on_the_card(cuda_device, method):
    """``track_sequences_batched`` on the card: each sequence's tracks equal
    ``track_sequence``'s with its own generator, bit for bit."""
    frames = bench_frontend.make_euroc_frames(
        bench_frontend.EurocSimParams(
            duration=1.6, nb_landmarks=120, fx=229.0, fy=228.0, cx=188.0,
            cy=120.0, width=376, height_px=240), seed=0)
    params = visual_frontend.FrontendParams(method=method)
    stack = np.stack([frames, frames[::-1], frames])
    gens = [torch.Generator(device=cuda_device).manual_seed(s)
            for s in (1, 2, 3)]
    batched = visual_frontend.track_sequences_batched(
        stack, params=params, generators=gens, device=cuda_device)
    for b, s in enumerate((1, 2, 3)):
        one = visual_frontend.track_sequence(
            stack[b], params=params, device=cuda_device,
            generator=torch.Generator(device=cuda_device).manual_seed(s))
        np.testing.assert_array_equal(batched[b], one)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "pcg", "matrix_free"])
def test_batched_ba_equals_own_solves_on_the_card(cuda_device, solver):
    """Three f32 windows (``bench.py``'s batched windows cut to 12 poses and
    300 landmarks; one moved far off, so it rejects steps the others
    accept) in one ``solve_ba_batched``: every window's accept flags equal
    its own ``solve_ba``'s on the card, costs within rtol 1e-5; one G/A
    call per window and iteration on the dense path; matrix-free, every
    window's CG steps through the fused matvec on its strided view of the
    union's W."""
    problems, states = [], []
    for i in range(3):
        pr, st = bench_problem.make_problem(num_poses=12, num_landmarks=300,
                                            obs_per_pose=60, seed=10 + i,
                                            device=cuda_device)
        if i == 1:
            gen = torch.Generator(device=cuda_device).manual_seed(0)
            st = st._replace(lm=st.lm + 2.5 * torch.randn(
                st.lm.shape, generator=gen, device=cuda_device))
        problems.append(pr)
        states.append(st)
    cfg_pcg, cfg_dense = bench_problem.batched_configs()
    cfg = {"dense": cfg_dense, "pcg": cfg_pcg,
           "matrix_free": dataclasses.replace(cfg_pcg,
                                              explicit_s="never")}[solver]
    before = segmm.dense_g_a_window.launches
    mv_before = segmm.matvec_pose_side.launches
    out, info = ba.solve_ba_batched(problems, states, cfg)
    launched = segmm.dense_g_a_window.launches - before
    if solver == "dense":
        assert launched == 3 * cfg.max_iterations
    if solver == "matrix_free":
        assert launched == 0
        assert segmm.matvec_pose_side.launches - mv_before == (
            3 * cfg.max_iterations * cfg.cg_max_iters)
    for b, (pr, st) in enumerate(zip(problems, states)):
        s1, i1 = ba.solve_ba(pr, st, cfg)
        assert torch.equal(info["accepted"][b], i1["accepted"])
        torch.testing.assert_close(info["costs"][b], i1["costs"], rtol=1e-5,
                                   atol=0)
        assert out.lm[b].shape == s1.lm.shape
    assert bool((info["final_cost"] < info["initial_cost"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [dict(), dict(with_odometry=True,
                                                with_priors=True)])
def test_ba_from_dataset_card_equals_cpu(cuda_device, flags):
    """The same dataset built into a problem on the card and on the CPU
    (noise from one CPU generator seed): the observation bank, weights,
    gauge and layout exactly, poses and banks within 1e-12."""
    params = vo_dataset.VoSimParams(nb_landmarks=100, steps=300, fx=200.0,
                                    fy=200.0, hz=10.0)
    lm = vo_dataset.draw_landmarks(params, 7)
    built = []
    for dev in (cuda_device, torch.device("cpu")):
        ds = vo_dataset.generate_vo_dataset(params, landmarks=lm, device=dev)
        built.append(ba.ba_from_dataset(
            ds, noise_pixels=1.1, generator=torch.Generator().manual_seed(0),
            device=dev, **flags))
    (pc, gc), (pp, gp) = built
    for f in ("pose_idx", "lm_idx", "weight", "free_pose", "K"):
        assert torch.equal(getattr(pc, f).cpu(), getattr(pp, f)), f
    assert torch.equal(pc.ell.sigma.cpu(), pp.ell.sigma)
    assert torch.equal(pc.ell.offsets.cpu(), pp.ell.offsets)
    torch.testing.assert_close(pc.uv.cpu(), pp.uv, rtol=0, atol=1e-9)
    for a, b in zip(gc, gp):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=1e-12)
    for bank in ("between", "priors"):
        if getattr(pp, bank) is not None:
            for a, b in zip(getattr(pc, bank), getattr(pp, bank)):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=1e-12)


def _png_chunk(t, body):
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + t + body
            + struct.pack(">I", zlib.crc32(t + body)))


def test_image_decoders_give_the_constructed_pixels(tmp_path):
    """The image codec is host code that needs no imaging library: files
    built here from known pixels (an Adam7 16-bit grayscale PNG, a 4-bit
    palette PNG, P5 and P6 at maxval 255, a bottom-up 24-bit BMP) decode to
    those pixels on whatever machine runs the tests."""
    import struct
    import zlib

    from libwave_tpu_torch.vision import images

    rng = np.random.default_rng(9)
    H, W = 5, 7
    gray = rng.integers(0, 256, (H, W)).astype(np.uint8)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    luma = images._to_luma(rgb)
    # 16-bit grayscale, Adam7: samples below 256 keep their value in PIL's
    # clip to L
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    data = b""
    for x0, y0, dx, dy in passes:
        sub = gray[y0::dy, x0::dx].astype(">u2")
        for row in sub:
            data += b"\x00" + row.tobytes()
    png16 = (b"\x89PNG\r\n\x1a\n"
             + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0,
                                               1))
             + _png_chunk(b"IDAT", zlib.compress(data))
             + _png_chunk(b"IEND", b""))
    idx = rng.integers(0, 16, (H, W)).astype(np.uint8)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    packed = np.zeros((H, (W + 1) // 2), np.uint8)
    for x in range(W):
        packed[:, x // 2] |= idx[:, x] << (4 * (1 - x % 2))
    pal_png = (b"\x89PNG\r\n\x1a\n"
               + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 4, 3, 0,
                                                 0, 0))
               + _png_chunk(b"PLTE", palette.tobytes())
               + _png_chunk(b"IDAT", zlib.compress(b"".join(
                   b"\x00" + r.tobytes() for r in packed)))
               + _png_chunk(b"IEND", b""))
    stride = (W * 3 + 3) & ~3
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :W * 3] = rgb[..., ::-1].reshape(H, -1)
    bmp_px = rows[::-1].tobytes()
    dib = struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0, len(bmp_px), 0, 0,
                      0, 0)
    bmp = (b"BM" + struct.pack("<IHHI", 54 + len(bmp_px), 0, 0, 54) + dib
           + bmp_px)
    cases = {
        "a.png": (png16, gray),
        "b.png": (pal_png, images._to_luma(palette)[idx]),
        "c.pgm": (b"P5\n%d %d\n255\n" % (W, H) + gray.tobytes(), gray),
        "d.ppm": (b"P6\n%d %d\n255\n" % (W, H) + rgb.tobytes(), luma),
        "e.bmp": (bmp, luma),
    }
    for name, (raw, want) in cases.items():
        (tmp_path / name).write_bytes(raw)
        np.testing.assert_array_equal(images.load_image(str(tmp_path / name)),
                                      want, err_msg=name)
    stack = images.read_image_sequence(str(tmp_path))
    assert stack.shape == (5, H, W)


# -------------------------------------------------------------------------
# the trajectory back end
# -------------------------------------------------------------------------


def _traces(got, ref, rtol=1e-9):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-20 * np.abs(ref).max())


@pytest.mark.cuda
def test_trajectory_solve_card_vs_cpu(cuda_device):
    from libwave_tpu_torch import bench_trajectory
    from libwave_tpu_torch.optim import factors

    truth = bench_trajectory.gps_truth(12)
    llh = bench_trajectory.gps_fixes(truth)
    enu = bench_trajectory.gps_fixes_enu(llh, cuda_device)
    state, fns, ok = bench_trajectory.gps_problem(truth, enu)
    factors.solve_trajectory_gn(state, fns, num_iters=1)
    with _no_sync():
        out, info = factors.solve_trajectory_gn(
            state, fns, num_iters=bench_trajectory.GPS_ITERS)
    state_c, fns_c, _ = bench_trajectory.gps_problem(truth, enu.cpu())
    out_c, info_c = factors.solve_trajectory_gn(
        state_c, fns_c, num_iters=bench_trajectory.GPS_ITERS)
    assert bool(ok.all())
    _traces(info["costs"], info_c["costs"])
    for a, b in zip(out, out_c):
        assert float((a.cpu() - b).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_lm_solve_card_vs_cpu(cuda_device):
    from libwave_tpu_torch import bench_trajectory
    from libwave_tpu_torch.optim import nlls

    x, y = bench_trajectory.curve_batch(64)
    cfg = nlls.LMConfig(max_iterations=bench_trajectory.CURVE_ITERS)

    def fit(X, Y, dev):
        p0 = torch.zeros(2, dtype=torch.float64, device=dev)
        if Y.dim() == 1:
            return nlls.lm_solve(nlls.exp_curve_residual, p0, args=(X, Y),
                                 config=cfg)
        return torch.func.vmap(lambda yy: nlls.lm_solve(
            nlls.exp_curve_residual, p0, args=(X, yy), config=cfg))(Y)

    X, Y = (torch.as_tensor(a, device=cuda_device) for a in (x, y))
    fit(X, Y[0], cuda_device)
    for Yd, Yc in ((Y[0], torch.as_tensor(y[0])), (Y, torch.as_tensor(y))):
        with _no_sync():
            res = fit(X, Yd, cuda_device)
        ref = fit(torch.as_tensor(x), Yc, "cpu")
        _traces(res.cost_trace, ref.cost_trace)
        assert float((res.x.cpu() - ref.x).abs().max()) <= 1e-9
        assert torch.equal(res.converged.cpu(), ref.converged)


@pytest.mark.cuda
def test_host_inputs_land_on_the_card(cuda_device):
    """With ``device=None``, a list datum, numpy points and a numpy curve
    fit run on the card; a tensor input keeps its own device."""
    from libwave_tpu_torch import bench_trajectory
    from libwave_tpu_torch.geography import world_frame
    from libwave_tpu_torch.optim import nlls

    datum = list(bench_trajectory.DATUM_LLH)
    for fn in (world_frame.enu_from_ecef_transform,
               world_frame.ecef_from_enu_transform):
        T = fn(datum)
        assert T.is_cuda and T.dtype == torch.float64
        torch.testing.assert_close(T.cpu(), fn(datum, device="cpu"),
                                   rtol=0, atol=1e-6)
    pts = np.random.default_rng(0).uniform(-100, 100, (8, 3))
    llh = world_frame.llh_point_from_enu(pts, datum)
    assert llh.is_cuda and llh.dtype == torch.float64
    assert world_frame.enu_point_from_llh(llh, datum).is_cuda
    assert not world_frame.enu_point_from_llh(llh.cpu(), datum).is_cuda
    x, y = bench_trajectory.curve_batch(1)
    res = nlls.curve_fit(lambda p, x: torch.exp(p[0] * x + p[1]), x, y[0],
                         np.zeros(2))
    assert res.x.is_cuda and res.cost_trace.is_cuda
    ref = nlls.curve_fit(lambda p, x: torch.exp(p[0] * x + p[1]), x, y[0],
                         np.zeros(2), device="cpu")
    assert float((res.x.cpu() - ref.x).abs().max()) <= 1e-9
    assert nlls.lm_solve(nlls.exp_curve_residual, np.zeros(2),
                         args=(x, y[0])).x.is_cuda


@pytest.mark.cuda
def test_float_exact_against_f64_oracle(cuda_device):
    from libwave_tpu_torch import bench_trajectory
    from libwave_tpu_torch.vision import flann_float

    d1, d2, src = bench_trajectory.planted_float(np.random.default_rng(42),
                                                 n_train=4096, n_query=4096)
    D1, D2 = (torch.as_tensor(a, device=cuda_device) for a in (d1, d2))
    m = torch.ones(4096, dtype=torch.bool, device=cuda_device)
    p = flann_float.FloatIndexParams(method="exact")
    idx, valid, _ = flann_float.float_match(
        D1, m, flann_float.build_float_index(D2, m, p), p)
    a, b = d1.astype(np.float64), d2.astype(np.float64)
    d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2.0 * a @ b.T
    s = np.sort(d, axis=1)
    clear = s[:, 1] - s[:, 0] > 1e-5 * s[:, 0]
    np.testing.assert_array_equal(idx.cpu().numpy()[clear],
                                  d.argmin(1)[clear])
    assert float(np.mean(idx.cpu().numpy() == src)) > 0.99


@pytest.mark.cuda
def test_kmeans_build_is_deterministic(cuda_device):
    from libwave_tpu_torch import bench_trajectory
    from libwave_tpu_torch.vision import flann_float

    _, d2, _ = bench_trajectory.planted_float(np.random.default_rng(42),
                                              n_train=16384, n_query=16)
    D2 = torch.as_tensor(d2, device=cuda_device)
    m = torch.ones(16384, dtype=torch.bool, device=cuda_device)
    p = flann_float.FloatIndexParams(method="kmeans", key_bits=9)
    before = segmm.seg_reduce_sorted.launches
    a = flann_float.build_float_index(D2, m, p)
    assert segmm.seg_reduce_sorted.launches - before == p.kmeans_iterations
    held = []

    def seg_reduce(vals, idx, n):
        got = segmm.seg_reduce(vals, idx, n)
        held.append(torch.equal(got, segmm.seg_reduce_reference(vals, idx,
                                                                n)))
        return got

    view = mock.Mock(wraps=segmm)
    view.seg_reduce = seg_reduce
    with mock.patch.object(flann_float, "segmm", view):
        b = flann_float.build_float_index(D2, m, p)
    assert held == [True] * p.kmeans_iterations
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.sorted_ids, b.sorted_ids)


@pytest.mark.cuda
def test_plain_g_a_is_bit_identical_across_runs(cuda_device):
    """The plain G/A sums a cell's duplicate-id slots in slot order, pass
    by pass, so its rounding no longer follows the card's atomics: bit for
    bit the same over 20 runs at the [3-700-257-0-257] shape (a third of
    each pose's slots share one id), and the kernel stays within its
    1e-6 * max|plain| bound of every run."""
    W, ids, hinv = _inputs(np.random.default_rng(0), cuda_device, 3, 700,
                           257, 0, 257)
    G0, A0 = segmm.dense_g_a_reference(W, ids, hinv)
    G, A = segmm.dense_g_a(W, ids, hinv)
    for _ in range(20):
        Gr, Ar = segmm.dense_g_a_reference(W, ids, hinv)
        assert torch.equal(Gr, G0) and torch.equal(Ar, A0)
    for x, ref in ((G, G0), (A, A0)):
        assert float((x - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.cuda
def test_sharded_one_rank_nccl_equals_single_device(cuda_device, tmp_path):
    """``solve_ba_sharded`` over a one-rank NCCL group (its collectives go
    through NCCL) gives the single-device ``solve_ba``'s numbers bit for
    bit, with the same segment launches, when that solve also takes the
    plain matvec and the plain self-blocks (the fused ones sum in other
    orders)."""
    import torch.distributed as dist

    from libwave_tpu_torch.parallel import (
        MeshConfig,
        MultiHostConfig,
        initialize_multihost,
        make_mesh,
        partition_ba_problem,
        solve_ba_sharded,
    )

    problem, state = bench_problem.make_problem(
        num_poses=20, num_landmarks=500, obs_per_pose=40, device=cuda_device)
    cfg = dataclasses.replace(bench_problem.bench_config(3),
                              explicit_s="never")
    initialize_multihost(MultiHostConfig(
        coordinator_address=f"file://{tmp_path / 'store'}",
        num_processes=1, process_id=0), backend="nccl")
    try:
        mesh = make_mesh(MeshConfig())
        assert mesh.backend == "nccl" and mesh.axis("dp").live
        stacked, padded = partition_ba_problem(problem, state, 1)
        before = segmm.seg_reduce_sorted.launches
        out, info = solve_ba_sharded(stacked, padded, mesh, cfg)
        sharded_launches = segmm.seg_reduce_sorted.launches - before
    finally:
        dist.destroy_process_group()
    # sharded blocks take the plain matvec and self-blocks: so does the
    # reference here
    before = segmm.seg_reduce_sorted.launches
    with mock.patch.object(schur, "_takes_fused_matvec", return_value=False), \
            mock.patch.object(segmm, "takes_self_blocks", return_value=False):
        ref, rinfo = ba.solve_ba(problem, state, cfg)
    assert segmm.seg_reduce_sorted.launches - before == sharded_launches
    assert torch.equal(info["costs"], rinfo["costs"])
    assert torch.equal(out.p, ref.p) and torch.equal(out.lm, ref.lm)


@pytest.mark.cuda
def test_profile_trace_names_the_kernel_after_earlier_sessions(cuda_device,
                                                              tmp_path):
    """``utils.trace.profile_trace`` records the segment reduce kernel, in
    its trace and its sums by kernel, when two other ``torch.profiler``
    sessions and a CUDA graph of the same kernel ran before it in the
    process."""
    from torch.profiler import ProfilerActivity, profile

    from libwave_tpu_torch.utils.trace import profile_trace

    g = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.randn((6, 4096), generator=g, device=cuda_device)
    ell = segmm.sorted_layout(torch.randint(0, 300, (4096,), generator=g,
                                            device=cuda_device), 300)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            segmm.seg_reduce_sorted(vals, *ell)
            (vals * 2.0).sum()
            torch.cuda.synchronize()
    bench_problem.device_ms(lambda: segmm.seg_reduce_sorted(vals, *ell), 5)
    with profile_trace(str(tmp_path)) as prof:
        segmm.seg_reduce_sorted(vals, *ell)
        torch.cuda.synchronize()
    assert "seg_reduce_sorted_kernel" in (tmp_path / "trace.json").read_text()
    assert any("seg_reduce_sorted_kernel" in e.key
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
