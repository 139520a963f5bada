"""Parity of libwave_tpu_torch.optim.schur with libwave_tpu.optim.schur.

Random f64 observation banks (made with numpy from a seed) and the
reference's synthetic BA dataset go through both packages. Tolerances:
- host layout functions (pack_observations, build_ell_layout,
  compute_band_plan): exact;
- f64 elementwise and reduction outputs (W, Hpp, Hll_inv, bp, bl, matvec,
  rhs, preconditioner, back-substitution): rtol 1e-10, with atol 1e-12 *
  max|x| for entries that cancel to rounding level;
- PCG and the dense solve: rtol 1e-8, since 20 Krylov steps (or a
  Cholesky) amplify last-bit differences of the operator by the system's
  condition number;
- explicit S (scatter, G/A full, chunked, banded): atol 2e-5 * max|S|, the
  bound the reference's own tests use (test_ba.py:414), because the G/A
  path rounds G, A and S_sub to f32 at any dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.optim import ba as jba
from libwave_tpu.optim import schur as js
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.optim import schur as ts

N, M = 6, 25


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(t, j, rtol=1e-10):
    t, j = _np(t), _np(j)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=1e-12 * max(np.abs(j).max(), 1e-300))


def _bank(rng):
    counts = rng.integers(3, 9, N)
    pose_idx = np.repeat(np.arange(N, dtype=np.int32), counts)
    lm_idx = rng.integers(0, M, pose_idx.size).astype(np.int32)
    uv = rng.normal(size=(pose_idx.size, 2))
    return pose_idx, lm_idx, uv


def _to_jax(x):
    return jax.tree.map(jnp.asarray, x)


@pytest.fixture
def lin(rng):
    """A pose-ELL linearized bank plus pose-graph terms (f64 numpy)."""
    pose_idx, lm_idx, _ = _bank(rng)
    pose_ell, lm_ell, pad, ell, = js.pack_observations(pose_idx, lm_idx, N, M)
    Pmax = lm_ell.shape[0] // N
    F = N - 1
    Ji, Jj = rng.normal(size=(2, F, 6, 6))
    rb = rng.normal(size=(F, 6))
    bi = np.arange(F, dtype=np.int32)
    bj = bi + 1
    extra_H = np.zeros((N, 6, 6))
    extra_b = np.zeros((N, 6))
    for f in range(F):
        extra_H[bi[f]] += Ji[f].T @ Ji[f]
        extra_H[bj[f]] += Jj[f].T @ Jj[f]
        extra_b[bi[f]] -= Ji[f].T @ rb[f]
        extra_b[bj[f]] -= Jj[f].T @ rb[f]
    free = np.ones(N)
    free[0] = 0.0
    return dict(
        r=rng.normal(size=(2, N, Pmax)),
        J_pose=rng.normal(size=(2, 6, N, Pmax)),
        J_lm=rng.normal(size=(2, 3, N, Pmax)),
        w=np.asarray(pad).reshape(N, Pmax) * rng.uniform(0.5, 1.5, (N, Pmax)),
        pose_idx=np.asarray(pose_ell), lm_idx=np.asarray(lm_ell),
        ell=jax.tree.map(np.asarray, ell), extra_H=extra_H, extra_b=extra_b,
        C=np.einsum("fai,faj->fij", Ji, Jj), ci=bi, cj=bj, free=free,
    )


def _blocks(lin, layout, with_pg=True, sum_dtype=None, dtype=np.float64):
    """(jax blocks, torch blocks) for one layout: "ell", "flat", "block"."""
    r, Jp, Jl, w = (lin[k].astype(dtype) for k in ("r", "J_pose", "J_lm", "w"))
    if layout != "ell":
        r, Jp, Jl = (x.reshape(x.shape[:-2] + (-1,)) for x in (r, Jp, Jl))
        w = w.reshape(-1)
    if layout == "block":
        r, Jp, Jl = r.T, np.moveaxis(Jp, -1, 0), np.moveaxis(Jl, -1, 0)
    args = [r, Jp, Jl, w, lin["pose_idx"], lin["lm_idx"], N, M, 1e-3,
            lin["free"]]
    kw = {}
    if with_pg:
        kw = dict(extra_Hpp=lin["extra_H"], extra_bp=lin["extra_b"],
                  couplings=(lin["C"], lin["ci"], lin["cj"]))
    ell = lin["ell"] if layout == "ell" else None
    conv_j = lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x
    conv_t = lambda x: torch.tensor(x) if isinstance(x, np.ndarray) else x
    bj = js.build_normal_equations(
        *map(conv_j, args), **jax.tree.map(conv_j, kw),
        ell=None if ell is None else _to_jax(ell),
        sum_dtype=None if sum_dtype is None else jnp.float64,
    )
    bt = ts.build_normal_equations(
        *map(conv_t, args),
        **{k: (tuple(map(conv_t, v)) if isinstance(v, tuple) else conv_t(v))
           for k, v in kw.items()},
        ell=None if ell is None else ts.EllLayout(
            *(torch.as_tensor(np.array(x)) for x in ell)),
        sum_dtype=None if sum_dtype is None else torch.float64,
    )
    return bj, bt


def test_pack_observations_and_layout(rng):
    pose_idx, lm_idx, uv = _bank(rng)
    perm = rng.permutation(pose_idx.size)  # unsorted input bank
    out_j = js.pack_observations(pose_idx[perm], lm_idx[perm], N, M,
                                 uv[perm], min_pmax=10)
    out_t = ts.pack_observations(pose_idx[perm], lm_idx[perm], N, M,
                                 uv[perm], min_pmax=10)
    for a, b in zip(out_j[:3] + out_j[4:], out_t[:3] + out_t[4:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(out_j[3], out_t[3]):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(chunk_cols=4, max_ranges=2, gap_tol=0),
    dict(chunk_cols=3, max_ranges=1, gap_tol=1),
])
def test_band_plan(kw, rng):
    pose_idx, lm_idx, _ = _bank(rng)
    lm_idx = np.sort(lm_idx)  # trajectory locality, so runs form
    _, lm_ell, pad, _ = js.pack_observations(pose_idx, lm_idx, N, M)
    pj = js.compute_band_plan(lm_ell, pad, N, M, **kw)
    pt = ts.compute_band_plan(torch.as_tensor(np.array(lm_ell)),
                              np.asarray(pad), N, M, **kw)
    assert pt.entries == pj.entries


def test_ell_seg_reduce_and_small_blocks(lin, rng):
    vals = rng.normal(size=(5, lin["lm_idx"].size))
    ell_t = ts.EllLayout(*(torch.as_tensor(np.array(x)) for x in lin["ell"]))
    close(ts.ell_seg_reduce(torch.as_tensor(vals), ell_t),
          js.ell_seg_reduce(jnp.asarray(vals), _to_jax(lin["ell"])))
    A = rng.normal(size=(7, 3, 3))
    close(ts.inv3x3(torch.as_tensor(A)), js.inv3x3(jnp.asarray(A)))
    s = rng.normal(size=(6, 11))
    close(ts.sym3_inv(torch.as_tensor(s)), js.sym3_inv(jnp.asarray(s)))
    v = rng.normal(size=(3, 11))
    close(ts.sym3_matvec(torch.as_tensor(s), torch.as_tensor(v)),
          js.sym3_matvec(jnp.asarray(s), jnp.asarray(v)))
    B = rng.normal(size=(4, 6, 6))
    spd = B @ np.swapaxes(B, -1, -2) + 6 * np.eye(6)
    close(ts.cho_inverse(torch.as_tensor(spd)), js.cho_inverse(jnp.asarray(spd)))


@pytest.mark.parametrize("layout", ["ell", "flat", "block"])
def test_normal_equations(layout, lin):
    bj, bt = _blocks(lin, layout)
    for f in ("Hpp", "Hll_inv", "W", "bp", "bl", "C"):
        assert getattr(bt, f).shape == getattr(bj, f).shape, f
        close(getattr(bt, f), getattr(bj, f))


def test_normal_equations_sum_dtype(lin):
    """f32 bank, f64 pose-block sums: the widened blocks come out f64 and
    agree with the reference to f32 rounding of the bank (1e-6 relative)."""
    bj, bt = _blocks(lin, "ell", sum_dtype=True, dtype=np.float32)
    assert bt.Hpp.dtype == bt.bp.dtype == bt.C.dtype == torch.float64
    assert bt.W.dtype == bt.Hll_inv.dtype == torch.float32
    for f in ("Hpp", "bp", "C", "W", "bl"):
        x, ref = _np(getattr(bt, f)), _np(getattr(bj, f))
        np.testing.assert_allclose(x, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["ell", "flat"])
def test_matvec_rhs_preconditioner_backsub(layout, lin, rng):
    bj, bt = _blocks(lin, layout)
    x = rng.normal(size=(N, 6))
    close(ts.schur_matvec(bt, torch.as_tensor(x)),
          js.schur_matvec(bj, jnp.asarray(x)))
    close(ts.schur_rhs(bt), js.schur_rhs(bj))
    close(ts.schur_jacobi_preconditioner(bt),
          js.schur_jacobi_preconditioner(bj))
    close(ts.back_substitute(bt, torch.as_tensor(x)),
          js.back_substitute(bj, jnp.asarray(x)))


@pytest.mark.parametrize("explicit", [False, True])
def test_pcg(explicit, lin):
    bj, bt = _blocks(lin, "ell")
    S4j = js.dense_reduced_system(bj) if explicit else None
    S4t = ts.dense_reduced_system(bt) if explicit else None
    cj = js.pcg(bj, js.schur_rhs(bj), max_iters=20, tol=1e-10, S4=S4j)
    ct = ts.pcg(bt, ts.schur_rhs(bt), max_iters=20, tol=1e-10, S4=S4t)
    close(ct.x, cj.x, rtol=1e-8)
    assert int(ct.iterations) == int(cj.iterations)


def test_dense_schur_solve_and_block_diagonal(lin):
    bj, bt = _blocks(lin, "ell")
    close(ts.dense_schur_solve(bt, ts.schur_rhs(bt)),
          js.dense_schur_solve(bj, js.schur_rhs(bj)), rtol=1e-8)
    S4 = ts.dense_reduced_system(bt)
    ar = torch.arange(N)
    # separated advanced indices go first (NumPy's rule): (N, D, D)
    assert S4[ar, :, ar, :].shape == (N, 6, 6)
    close(S4[ar, :, ar, :], np.asarray(js.dense_reduced_system(bj))[
        np.arange(N), :, np.arange(N), :])


@pytest.mark.parametrize("layout", ["ell", "flat"])
def test_scatter_reduced_system(layout, lin):
    bj, bt = _blocks(lin, layout)
    close(ts.dense_reduced_system(bt, _force_path="scatter"),
          js.dense_reduced_system(bj, _force_path="xla"))


def test_sharded_path_not_ported(lin):
    with pytest.raises(NotImplementedError):
        ts.build_normal_equations(
            *(torch.zeros(1) for _ in range(6)), 1, 1, 0.0, torch.ones(1),
            axis_name="dp",
        )


@pytest.fixture(scope="module")
def dataset_blocks():
    """Blocks of the reference's 100-landmark dataset (test_ba.py:38-52)
    at a perturbed state, from both packages. The seed keeps every
    perturbed landmark away from the cameras: where one lands next to a
    camera (seed 31: max|W| = 2.3e8), the reference's f32 G/A contract
    itself departs from its own exact S by 4.9e3, far beyond the bound."""
    ds = generate_vo_dataset(
        VoSimParams(nb_landmarks=100, steps=300, fx=200.0, fy=200.0,
                    hz=10.0),
        jax.random.key(7),
    )
    problem, gt = jba.ba_from_dataset(ds)
    rng = np.random.default_rng(2)
    n, m = gt.q.shape[0], gt.lm.shape[0]
    free = np.asarray(problem.free_pose)[:, None]
    from libwave_tpu.geometry import so3 as jso3
    init = jba.BAState(
        q=jso3.quat_boxplus(gt.q, jnp.asarray(
            0.03 * rng.normal(size=(n, 3)) * free)),
        p=gt.p + 0.05 * rng.normal(size=(n, 3)) * free,
        lm=gt.lm + 0.3 * rng.normal(size=(m, 3)),
    )
    pn, sn = jax.tree.map(np.asarray, (problem, init))
    pt, st = interop.from_jax_numpy(pn, sn, "cpu")
    bj = jba._linearize_ba(problem, init, 1e-4, None, None)
    bt = tba._linearize_ba(pt, st, torch.tensor(1e-4, dtype=torch.float64))
    return problem, bj, bt


@pytest.mark.parametrize("form", ["scatter", "g_a_full", "chunked", "banded"])
def test_reduced_system_forms(form, dataset_blocks):
    problem, bj, bt = dataset_blocks
    S_ref = np.asarray(js.dense_reduced_system(bj))
    n, m = bt.Hpp.shape[0], bt.bl.shape[-1]
    kw, jkw = {}, {}
    if form == "scatter":
        kw = jkw = {}
    elif form == "g_a_full":
        kw, jkw = dict(_force_path="kernel"), dict(_force_path="kernel")
    elif form == "chunked":
        g_bytes = 4 * n * 6 * 3 * m
        kw = dict(max_g_bytes=g_bytes / 3.5, _force_path="kernel")
        jkw = dict(kw)
    else:
        pad = (np.asarray(problem.weight) > 0).astype(np.float64)
        plan = js.compute_band_plan(np.asarray(problem.lm_idx), pad, n, m,
                                    chunk_cols=32, max_ranges=3, gap_tol=1)
        assert len(plan.entries) > 1
        assert any(len(r) > 1 for (_, _, r) in plan.entries)
        kw = dict(bands=ts.BandPlan(plan.entries), _force_path="kernel")
        jkw = dict(bands=plan, _force_path="kernel")
    S_t = ts.dense_reduced_system(bt, **kw).numpy()
    S_j = np.asarray(js.dense_reduced_system(bj, **jkw))
    tol = 2e-5 * np.abs(S_ref).max()
    np.testing.assert_allclose(S_t, S_j, rtol=1e-4, atol=tol)
    np.testing.assert_allclose(S_t, S_ref, rtol=1e-4, atol=tol)
