"""Card-only tests of the port: the G/A CUDA kernel against its plain
PyTorch version, its input checks, and a small solve through it.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine with the card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version sum the same f32 terms, only the order of
duplicate-id sums may differ: tolerance 1e-6 * max|plain|.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.optim import ba, schur


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
    before = segmm.dense_g_a.launches
    G, A = segmm.dense_g_a(W, ids, hinv)
    assert segmm.dense_g_a.launches == before + 1
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
    before = segmm.dense_g_a.launches
    _, info = ba.solve_ba(problem, state, cfg)
    calls = sum(len(r) for _, _, r in problem.bands.entries)
    assert segmm.dense_g_a.launches - before == 3 * calls
    with mock.patch.object(schur, "dense_g_a", segmm.dense_g_a_reference):
        _, info_p = ba.solve_ba(problem, state, cfg)
    costs, costs_p = info["costs"].cpu().numpy(), info_p["costs"].cpu().numpy()
    assert np.isfinite(costs).all() and costs[-1] < float(info["initial_cost"])
    np.testing.assert_allclose(costs, costs_p, rtol=1e-3)
