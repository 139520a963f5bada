"""The port's G/A build (libwave_tpu_torch.ops.segmm) against the Pallas
kernel of libwave_tpu.ops.segmm, run in interpret mode on the CPU.

Both follow the reference kernel's f32 contract: G is summed (in the input
dtype here) and rounded to f32, A is formed in f32 from f32 G and Hinv.
Tolerances:
- G: 1e-12 * max|G| at f64 (both round the same f64 sums to f32) and
  1e-6 * max|G| at f32 (the same f32 terms, summed in another order);
- A: 1e-6 * max|A| at both dtypes. XLA forms the Pallas kernel's f32
  products and sums in an order (and with contractions) PyTorch does not
  reproduce, so A differs by f32 rounding even when G is identical:
  measured one f32 ulp, about 6e-8 * max|A|.

The window entry point (dense_g_a_window: poses [plo, phi) x columns
[c0, c1) of the full W and hinv, the slots taken from the landmark-sorted
layout) is held to the same tolerances against the Pallas kernel on the
window's slices, and to exact equality against the plain version on the
slices of W, ids and hinv that the dense reduced system cut before it
existed: both add the same f32 values in the same order, the slots the
layout leaves out having W exactly zero.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
compares it with the plain version there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.ops.segmm import dense_g_a_onehot
from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.optim import schur as ts


def _inputs(rng, N, P, M, dtype, lo=0, hi=None, dup=False, pad_rows=()):
    hi = M if hi is None else hi
    W = rng.standard_normal((18, N, P)).astype(dtype)
    ids = rng.integers(lo, hi, (N, P)).astype(np.int32)
    W[:, :, -3:] = 0.0  # zero-weight padding slots (the ELL contract)
    ids[:, -3:] = 0
    if dup:
        ids[:, : P // 3] = ids[:, :1]
    for n in pad_rows:
        ids[n] = -1  # the pose-padding id
    hinv = rng.standard_normal((6, M)).astype(dtype)
    return W, ids, hinv


CASES = {
    # name: (N, P, M, lo, hi, dup, pad_rows)
    "plain": (7, 40, 61, 0, None, False, ()),
    "duplicates": (5, 37, 300, 0, 300, True, ()),
    "padding_rows": (6, 37, 300, 0, 300, False, (1, 4)),
    "chunk_offset": (4, 64, 300, -250, 400, True, ()),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_g_a_matches_pallas(case, dtype, rng):
    N, P, M, lo, hi, dup, pad_rows = CASES[case]
    W, ids, hinv = _inputs(rng, N, P, M, dtype, lo, hi, dup, pad_rows)
    gj, aj = dense_g_a_onehot(jnp.asarray(W), jnp.asarray(ids),
                              jnp.asarray(hinv))
    gt, at = segmm.dense_g_a(torch.as_tensor(W), torch.as_tensor(ids),
                             torch.as_tensor(hinv))
    assert gt.shape == at.shape == (N, 18, M)
    assert gt.dtype == at.dtype == torch.from_numpy(W).dtype
    gj, aj = np.asarray(gj), np.asarray(aj)
    g_tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=g_tol * np.abs(gj).max())
    np.testing.assert_allclose(at.numpy(), aj, rtol=0,
                               atol=1e-6 * np.abs(aj).max())
    for n in pad_rows:
        assert not gt[n].any() and not at[n].any()


def test_out_of_range_ids_contribute_nothing(rng):
    """A chunked caller's view: ids shifted by c0, only [0, M) counts."""
    W, ids, hinv = _inputs(rng, 3, 20, 50, np.float64, -60, 110)
    G, _ = segmm.dense_g_a_reference(torch.as_tensor(W), torch.as_tensor(ids),
                                     torch.as_tensor(hinv))
    ref = np.zeros((3, 18, 50))
    for n in range(3):
        for s in range(20):
            if 0 <= ids[n, s] < 50:
                ref[n, :, ids[n, s]] += W[:, n, s]
    np.testing.assert_allclose(G.numpy(), ref.astype(np.float32), rtol=0,
                               atol=0)


def test_cpu_path_counts_no_launch(rng):
    W, ids, hinv = _inputs(rng, 2, 8, 10, np.float32)
    W, ids, hinv = (torch.as_tensor(a) for a in (W, ids, hinv))
    before = segmm.dense_g_a_window.launches
    segmm.dense_g_a(W, ids, hinv)
    segmm.dense_g_a_window(W, segmm.sorted_layout(ids.reshape(-1), 10), hinv,
                           2, 7, 0, 2)
    assert segmm.dense_g_a_window.launches == before


def test_non_cpu_non_cuda_tensor_raises():
    W = torch.zeros((18, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segmm.dense_g_a(W, torch.zeros((2, 4), dtype=torch.int32,
                                       device="meta"),
                        torch.zeros((6, 5), device="meta"))


EDGE = bench_problem.g_a_edge_cases()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", range(len(EDGE)))
def test_window_plain_matches_pallas(case, dtype):
    _, W, ids, hinv, windows = EDGE[case]
    W, hinv = W.astype(dtype), hinv.astype(dtype)
    ell = segmm.sorted_layout(torch.as_tensor(ids.reshape(-1)), hinv.shape[1])
    g_tol = 1e-12 if dtype == np.float64 else 1e-6
    for c0, c1, plo, phi in windows:
        gj, aj = dense_g_a_onehot(jnp.asarray(W[:, plo:phi]),
                                  jnp.asarray(ids[plo:phi] - c0),
                                  jnp.asarray(hinv[:, c0:c1]))
        gt, at = segmm.dense_g_a_window(torch.as_tensor(W), ell,
                                        torch.as_tensor(hinv), c0, c1, plo,
                                        phi)
        assert gt.shape == at.shape == (phi - plo, 18, c1 - c0)
        gj, aj = np.asarray(gj), np.asarray(aj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                   atol=g_tol * np.abs(gj).max())
        np.testing.assert_allclose(at.numpy(), aj, rtol=0,
                                   atol=1e-6 * np.abs(aj).max())


def test_layout_ids():
    ids = torch.tensor([3, -1, 0, 3, 5, 9, 0, 2, 3], dtype=torch.int32)
    ell = segmm.sorted_layout(ids, 6)  # 9 and -1 in no run, 1 and 4 empty
    want = torch.where((ids >= 0) & (ids < 6), ids, -1)
    assert torch.equal(segmm.layout_ids(ell, 9), want)
    assert torch.equal(segmm.layout_ids(segmm.sorted_layout(ids, 0), 9),
                       torch.full((9,), -1, dtype=torch.int32))


def test_window_plain_matches_todays_slices_at_band_calls():
    """Every band call of a small banded problem whose layout leaves the
    zero-weight slots out of the runs: the window route equals the plain
    G/A on the slices of W, lm_slot - c0 and hinv, bit for bit."""
    problem, state = bench_problem.make_problem(
        num_poses=20, num_landmarks=500, obs_per_pose=120, device="cpu")
    assert bool((problem.weight == 0).any())
    blocks = tba._linearize_ba(problem, state, torch.tensor(1e-4))
    N = blocks.Hpp.shape[0]
    plan = ts.compute_band_plan(problem.lm_idx, problem.weight > 0, N, 500,
                                chunk_cols=64, max_ranges=3, gap_tol=1)
    calls = [(c0, c1, plo, phi) for c0, c1, ranges in plan.entries
             for plo, phi in ranges]
    assert len(plan.entries) > 1
    lm_slot = blocks.lm_idx.reshape(N, -1)
    for c0, c1, plo, phi in calls:
        G, A = segmm.dense_g_a_window(blocks.W, blocks.ell, blocks.Hll_inv,
                                      c0, c1, plo, phi)
        Gr, Ar = segmm.dense_g_a_reference(
            blocks.W[:, plo:phi], lm_slot[plo:phi] - c0,
            blocks.Hll_inv[:, c0:c1])
        assert torch.equal(G, Gr) and torch.equal(A, Ar)
