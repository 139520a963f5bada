"""The port's segment reduce and broadcast (libwave_tpu_torch.ops.segmm)
against the JAX package's one-hot Pallas kernels, run in interpret mode on
the CPU as tests/test_ops.py runs them, and the matrix-free Schur path that
routes its landmark-side crossings through them.

Tolerances:
- broadcast: exact (both copy one value or write zero);
- reduce: 1e-6 * sum|vals| per output against the Pallas kernel at both
  dtypes (it sums in MXU order and accumulates in f32 even for f64 input,
  ``preferred_element_type=float32``), and 1e-12 * sum|vals| at f64
  against an exact numpy sum in slot order; the sorted reduce against the
  JAX package's log-shift ``ell_seg_reduce`` at 1e-12 * sum|vals| (f64);
- the matrix-free matvec, rhs and back-substitution at f64: rtol 1e-10;
  the 3-iteration ``solve_ba(explicit_s="never")`` cost trajectory at f64:
  rtol 1e-9.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libwave_tpu.ops.segmm import seg_broadcast_onehot, seg_reduce_onehot
from libwave_tpu.optim import ba as jba
from libwave_tpu.optim import schur as js
from libwave_tpu_torch import bench_problem, interop
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.optim import schur as ts

CASES = {
    # name: (C, K, M, lo, hi)
    "aligned": (3, 1024, 512, 0, 512),
    "unaligned_ids_past_M": (6, 1537, 701, 0, 760),
    "empty_segments": (1, 100, 1000, 0, 1000),
    "negative_ids": (3, 777, 333, -40, 333),
}


def _bank(rng, C, K, M, lo, hi, dtype):
    idx = rng.integers(lo, hi, K).astype(np.int32)
    vals = rng.standard_normal((C, K)).astype(dtype)
    pad = rng.random(K) < 0.2
    idx[pad] = 0  # ELL-style padding: id 0, zero values
    vals[:, pad] = 0.0
    return vals, idx


def _per_output_bound(vals, idx, M, rel):
    scale = np.zeros((vals.shape[0], M))
    ok = (idx >= 0) & (idx < M)
    np.add.at(scale.T, idx[ok], np.abs(vals[:, ok]).T.astype(np.float64))
    return rel * scale


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reduce_matches_pallas(case, dtype, rng):
    C, K, M, lo, hi = CASES[case]
    vals, idx = _bank(rng, C, K, M, lo, hi, dtype)
    ref = np.asarray(seg_reduce_onehot(jnp.asarray(vals), jnp.asarray(idx),
                                       M))
    got = segmm.seg_reduce(torch.as_tensor(vals), torch.as_tensor(idx), M)
    assert got.shape == (C, M) and got.dtype == torch.from_numpy(vals).dtype
    err = np.abs(got.numpy().astype(np.float64) - ref.astype(np.float64))
    assert (err <= _per_output_bound(vals, idx, M, 1e-6)).all()
    if dtype == np.float64:
        exact = np.zeros((C, M))
        ok = (idx >= 0) & (idx < M)
        np.add.at(exact.T, idx[ok], vals[:, ok].T)
        err = np.abs(got.numpy() - exact)
        assert (err <= _per_output_bound(vals, idx, M, 1e-12)).all()
    # empty segments and ids outside [0, M) give exact zeros
    seen = np.zeros(M, bool)
    seen[idx[(idx >= 0) & (idx < M)]] = True
    assert not got.numpy()[:, ~seen].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_broadcast_matches_pallas(case, rng):
    C, K, M, lo, hi = CASES[case]
    _, idx = _bank(rng, C, K, M, lo, hi, np.float32)
    y = rng.standard_normal((C, M)).astype(np.float32)
    ref = np.asarray(seg_broadcast_onehot(jnp.asarray(y), jnp.asarray(idx)))
    got = segmm.seg_broadcast(torch.as_tensor(y), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    out = (idx < 0) | (idx >= M)
    assert not got.numpy()[:, out].any()


BROADCAST_EDGES = bench_problem.broadcast_edge_cases()


@pytest.mark.parametrize("case", range(len(BROADCAST_EDGES)),
                         ids=[c[0] for c in BROADCAST_EDGES])
def test_broadcast_edge_cases_match_pallas(case):
    """K not a multiple of 4 and an id view with a storage offset (the
    kernel's scalar path on the card): the plain version equals the Pallas
    kernel exactly."""
    _, y, ids, off = BROADCAST_EDGES[case]
    y = y.astype(np.float32)
    ref = np.asarray(seg_broadcast_onehot(jnp.asarray(y),
                                          jnp.asarray(ids[off:])))
    idx = torch.as_tensor(ids)[off:]
    assert idx.storage_offset() == off and idx.is_contiguous()
    got = segmm.seg_broadcast(torch.as_tensor(y), idx)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sorted_reduce_matches_log_shift_scan(rng):
    """The layout's sorted reduce against the JAX package's ell_seg_reduce
    on a packed bank, with and without the padding slots in the runs."""
    N, M = 7, 40
    counts = rng.integers(2, 12, N)
    pose_idx = np.repeat(np.arange(N, dtype=np.int32), counts)
    lm_idx = rng.integers(0, M, pose_idx.size).astype(np.int32)
    _, lm_ell, pad, ell_j = js.pack_observations(pose_idx, lm_idx, N, M)
    vals = rng.standard_normal((5, lm_ell.shape[0])) * np.asarray(pad)
    ref = np.asarray(js.ell_seg_reduce(jnp.asarray(vals), ell_j))
    _, _, _, ell_packed = ts.pack_observations(pose_idx, lm_idx, N, M,
                                               device="cpu")
    ell_all = ts.build_ell_layout(np.asarray(lm_ell), M, device="cpu")
    for ell in (ell_packed, ell_all):
        got = ts.ell_seg_reduce(torch.as_tensor(vals), ell).numpy()
        bound = _per_output_bound(vals, np.asarray(lm_ell), M, 1e-12)
        assert (np.abs(got - ref) <= bound + 1e-300).all()
    assert ell_packed.offsets[-1] == int(np.asarray(pad).sum())
    assert ell_all.offsets[-1] == lm_ell.shape[0]


def test_plain_versions_add_in_slot_order():
    """The plain sorted reduce adds each run from zero in slot order, the
    kernel's order: a sum that rounds differently in any other order."""
    vals = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)
    sigma = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 4], dtype=torch.int32)
    # ((1e8 + 1) - 1e8) + 1 = 1 in f32 (1e8 + 1 rounds to 1e8)
    got = segmm.seg_reduce_sorted(vals, sigma, offsets)
    assert got.item() == 1.0
    assert segmm.seg_reduce_sorted.launches == 0


def test_cpu_paths_count_no_launch_and_other_devices_raise():
    before = (segmm.seg_reduce_sorted.launches, segmm.seg_broadcast.launches)
    segmm.seg_reduce(torch.ones(2, 5), torch.zeros(5, dtype=torch.int32), 3)
    segmm.seg_broadcast(torch.ones(2, 3), torch.zeros(5, dtype=torch.int32))
    assert (segmm.seg_reduce_sorted.launches,
            segmm.seg_broadcast.launches) == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segmm.seg_reduce_sorted(torch.zeros(2, 4, **meta),
                                torch.zeros(4, dtype=torch.int32, **meta),
                                torch.zeros(3, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        segmm.seg_broadcast(torch.zeros(2, 4, **meta),
                            torch.zeros(4, dtype=torch.int32, **meta))


SMALL = dict(num_poses=12, num_landmarks=400, obs_per_pose=60, seed=3)


@pytest.fixture(scope="module")
def headline_f64():
    """The headline generator at a small size, f64, in both packages."""
    pj, sj = bench.make_problem(**SMALL)

    def f64(x):
        x = np.asarray(x)
        return x.astype(np.float64) if x.dtype == np.float32 else x

    pj = pj._replace(**{f: jnp.asarray(f64(getattr(pj, f)))
                        for f in ("K", "uv", "weight", "free_pose")})
    sj = jba.BAState(*(jnp.asarray(f64(x)) for x in sj))
    pt, st = interop.from_jax_numpy(jax.tree.map(np.asarray, pj),
                                    jax.tree.map(np.asarray, sj), "cpu")
    return pj, sj, pt, st


def test_matrix_free_operators_match(headline_f64, rng):
    pj, sj, pt, st = headline_f64
    bj = jba._linearize_ba(pj, sj, 1e-4, None, None)
    bt = tba._linearize_ba(pt, st, torch.tensor(1e-4, dtype=torch.float64))
    x = rng.normal(size=(SMALL["num_poses"], 6))

    def close(t, j):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-10,
                                   atol=1e-12 * np.abs(j).max())

    close(ts.schur_matvec(bt, torch.as_tensor(x)),
          js.schur_matvec(bj, jnp.asarray(x)))
    close(ts.schur_rhs(bt), js.schur_rhs(bj))
    close(ts.back_substitute(bt, torch.as_tensor(x)),
          js.back_substitute(bj, jnp.asarray(x)))


def test_matrix_free_solve_trajectory(headline_f64):
    pj, sj, pt, st = headline_f64
    cfg_j = jba.BAConfig(max_iterations=3, cg_max_iters=20, cg_tol=1e-5,
                         explicit_s="never", relative_decrease_tol=0.0,
                         absolute_decrease_tol=0.0)
    cfg_t = dataclasses.replace(bench_problem.bench_config(3),
                                explicit_s="never")
    _, info_j = jba.solve_ba(pj, sj, cfg_j)
    _, info_t = tba.solve_ba(pt, st, cfg_t)
    np.testing.assert_allclose(info_t["costs"].numpy(),
                               np.asarray(info_j["costs"]), rtol=1e-9)
    assert info_t["costs"][-1] < info_t["initial_cost"]
