"""Card-only tests of the port: the G/A, segment and Hamming CUDA kernels
against their plain PyTorch versions, their input checks, and small solves
(explicit-S and matrix-free BA, dense and PCG VIO) and a small front-end
sequence through them.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine with the card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

G/A kernel and plain version sum the same f32 terms, only the order of
duplicate-id sums may differ: tolerance 1e-6 * max|plain|, and exact
equality at every cell that takes at most one nonzero slot. The segment
reduce adds in the plain version's order: equal bit for bit, and
bit-identical across runs; the broadcast copies: exact equality. The
Hamming outputs are integers: exact equality.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from libwave_tpu_torch import bench_frontend, bench_problem
from libwave_tpu_torch.ops import hamming, segmm
from libwave_tpu_torch.optim import ba, schur
from libwave_tpu_torch.pipelines import vio, visual_frontend
from libwave_tpu_torch.sim import vo_dataset
from libwave_tpu_torch.utils import precision


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
    before = segmm.dense_g_a_window.launches
    _, info = ba.solve_ba(problem, state, cfg)
    calls = sum(len(r) for _, _, r in problem.bands.entries)
    assert segmm.dense_g_a_window.launches - before == 3 * calls
    with mock.patch.object(schur, "dense_g_a_window",
                           segmm.dense_g_a_window_reference):
        _, info_p = ba.solve_ba(problem, state, cfg)
    costs, costs_p = info["costs"].cpu().numpy(), info_p["costs"].cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < float(info["initial_cost"])
    np.testing.assert_allclose(costs, costs_p, rtol=1e-3)


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
    before = _launches()
    _, info = ba.solve_ba(problem, state, cfg)
    # per LM iteration: Hll, bl, back-substitution and one reduce per CG
    # step; schur_rhs, the preconditioner and one broadcast per CG step
    assert tuple(a - b for a, b in zip(_launches(), before)) == (
        0, 3 * (3 + cg), 3 * (2 + cg))
    with _plain_crossings():
        _, info_p = ba.solve_ba(problem, state, cfg)
    assert _launches()[1:] == (before[1] + 3 * (3 + cg),
                               before[2] + 3 * (2 + cg))
    costs, costs_p = info["costs"].cpu().numpy(), info_p["costs"].cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < float(info["initial_cost"])
    np.testing.assert_allclose(costs, costs_p, rtol=1e-3)


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
