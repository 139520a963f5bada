"""Parity of libwave_tpu_torch.optim.schur with libwave_tpu.optim.schur.

Random f64 observation banks (made with numpy from a seed) and the
reference's synthetic BA dataset go through both packages. Tolerances:
- host layout functions (pack_observations, build_ell_layout,
  compute_band_plan): exact. The port's landmark layout is a stable
  landmark-sorted slot list with CSR offsets; the JAX package's holds the
  same order with log-shift masks and segment ends;
- f64 elementwise and reduction outputs (W, Hpp, Hll_inv, bp, bl, matvec,
  rhs, preconditioner, back-substitution): rtol 1e-10, with atol 1e-12 *
  max|x| for entries that cancel to rounding level;
- PCG and the dense solve: rtol 1e-8, since 20 Krylov steps (or a
  Cholesky) amplify last-bit differences of the operator by the system's
  condition number;
- explicit S (scatter, G/A full, chunked, banded): atol 2e-5 * max|S|, the
  bound the reference's own tests use (test_ba.py:414), because the G/A
  path rounds G, A and S_sub to f32 at any dtype;
- the explicit-S contraction runs with TF32 off whatever the caller set:
  a recorded flag, exact.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.optim import ba as jba
from libwave_tpu.optim import schur as js
from libwave_tpu.sim import VoSimParams, generate_vo_dataset
from libwave_tpu_torch import interop
from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.optim import schur as ts
from libwave_tpu_torch.utils import precision

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


def _blocks(lin, layout, with_pg=True, sum_dtype=None, dtype=np.float64,
            axis_name=None):
    """(jax blocks, torch blocks) for one layout: "ell", "flat", "block";
    ``axis_name`` goes to the port's build only."""
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
        ell=None if ell is None else ts.build_ell_layout(
            lin["lm_idx"], M, device="cpu"),
        sum_dtype=None if sum_dtype is None else torch.float64,
        axis_name=axis_name,
    )
    return bj, bt


def test_pack_observations_and_layout(rng):
    pose_idx, lm_idx, uv = _bank(rng)
    perm = rng.permutation(pose_idx.size)  # unsorted input bank
    out_j = js.pack_observations(pose_idx[perm], lm_idx[perm], N, M,
                                 uv[perm], min_pmax=10)
    out_t = ts.pack_observations(pose_idx[perm], lm_idx[perm], N, M,
                                 uv[perm], min_pmax=10, device="cpu")
    for a, b in zip(out_j[:3] + out_j[4:], out_t[:3] + out_t[4:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lm_ell, pad = np.asarray(out_j[1]), np.asarray(out_j[2]) > 0
    assert not pad.all()  # min_pmax=10 pads every pose
    check_layout(out_t[3], out_j[3], lm_ell, pad)
    # every slot counts when no padding mask is given: the JAX order
    full = ts.build_ell_layout(lm_ell, M, device="cpu")
    np.testing.assert_array_equal(full.sigma.numpy(), np.asarray(out_j[3].sigma))
    check_layout(full, out_j[3], lm_ell, np.ones_like(pad))


def check_layout(ell_t, ell_j, lm_idx, valid):
    """The port's (sigma, offsets) against the JAX package's layout of the
    same bank: landmark m's run is its valid slots in slot order; runs end
    where the JAX package's segments end."""
    sigma, offsets = ell_t.sigma.numpy(), ell_t.offsets.numpy()
    assert sigma.dtype == offsets.dtype == np.int32
    assert offsets.shape == (M + 1,) and offsets[0] == 0
    assert offsets[-1] == valid.sum()
    np.testing.assert_array_equal(np.sort(sigma), np.arange(lm_idx.size))
    has = np.asarray(ell_j.has_obs) > 0
    for m in range(M):
        run = sigma[offsets[m]:offsets[m + 1]]
        np.testing.assert_array_equal(
            run, np.nonzero((lm_idx == m) & valid)[0])
        if valid.all():
            assert (run.size > 0) == has[m]
            if has[m]:
                assert offsets[m + 1] - 1 == np.asarray(ell_j.seg_last)[m]


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
    ell_t = ts.build_ell_layout(lin["lm_idx"], M, device="cpu")
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
    """The sharded (``axis_name``) build, a stub that raised until the
    distributed layer was ported: on a one-rank axis (identity
    collectives) it gives the single-device blocks, in both layouts, and
    the explicit reduced system refuses sharded blocks."""
    from libwave_tpu_torch.parallel.mesh import Axis

    for layout in ("ell", "flat"):
        _, bt = _blocks(lin, layout)
        _, sharded = _blocks(lin, layout, axis_name=Axis("dp", 1, 0))
        for f in ("Hpp", "Hll_inv", "W", "bp", "bl", "C"):
            assert torch.equal(getattr(sharded, f), getattr(bt, f)), f
        close(ts.schur_matvec(sharded, sharded.bp),
              ts.schur_matvec(bt, bt.bp), rtol=0)
        with pytest.raises(ValueError, match="sharded"):
            ts.dense_reduced_system(sharded)


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


def _form_kw(form, problem, n, m):
    """(port kwargs, reference kwargs) of ``dense_reduced_system`` for one
    form of the explicit S."""
    if form == "scatter":
        return {}, {}
    if form == "g_a_full":
        return dict(_force_path="kernel"), dict(_force_path="kernel")
    if form == "chunked":
        g_bytes = 4 * n * 6 * 3 * m
        kw = dict(max_g_bytes=g_bytes / 3.5, _force_path="kernel")
        return kw, dict(kw)
    pad = (np.asarray(problem.weight) > 0).astype(np.float64)
    plan = js.compute_band_plan(np.asarray(problem.lm_idx), pad, n, m,
                                chunk_cols=32, max_ranges=3, gap_tol=1)
    assert len(plan.entries) > 1
    assert any(len(r) > 1 for (_, _, r) in plan.entries)
    return (dict(bands=ts.BandPlan(plan.entries), _force_path="kernel"),
            dict(bands=plan, _force_path="kernel"))


@pytest.mark.parametrize("form", ["scatter", "g_a_full", "chunked", "banded"])
def test_reduced_system_forms(form, dataset_blocks):
    problem, bj, bt = dataset_blocks
    S_ref = np.asarray(js.dense_reduced_system(bj))
    n, m = bt.Hpp.shape[0], bt.bl.shape[-1]
    kw, jkw = _form_kw(form, problem, n, m)
    S_t = ts.dense_reduced_system(bt, **kw).numpy()
    S_j = np.asarray(js.dense_reduced_system(bj, **jkw))
    tol = 2e-5 * np.abs(S_ref).max()
    np.testing.assert_allclose(S_t, S_j, rtol=1e-4, atol=tol)
    np.testing.assert_allclose(S_t, S_ref, rtol=1e-4, atol=tol)


@pytest.mark.parametrize("form", ["g_a_full", "chunked", "banded"])
def test_reduced_system_window_route_matches_slices(form, dataset_blocks,
                                                    monkeypatch):
    """The G/A path through the window entry point (full W, the layout and
    window bounds) gives the S that slicing W, lm_idx - c0 and Hll^-1 per
    build call gave, bit for bit."""
    problem, _, bt = dataset_blocks
    n, m = bt.Hpp.shape[0], bt.bl.shape[-1]
    kw, _ = _form_kw(form, problem, n, m)
    S_window = ts.dense_reduced_system(bt, **kw)
    lm_slot = bt.lm_idx.reshape(n, -1)

    def sliced(W, ell, hinv, c0, c1, plo, phi):
        return segmm.dense_g_a_reference(
            W[:, plo:phi], lm_slot[plo:phi] - c0, hinv[:, c0:c1])

    monkeypatch.setattr(ts, "dense_g_a_window", sliced)
    assert torch.equal(S_window, ts.dense_reduced_system(bt, **kw))


@contextlib.contextmanager
def _tf32_allowed():
    """Let float32 CUDA matmuls take TF32, as a careless caller might;
    restore the flags after."""
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


def _matmul_setting():
    mm = torch.backends.cuda.matmul
    return mm.fp32_precision if precision._new_api() else mm.allow_tf32


@pytest.mark.parametrize("fn", ["dense_reduced_system", "dense_schur_solve"])
@pytest.mark.parametrize("form", ["g_a_full", "chunked", "banded"])
def test_explicit_s_contraction_pins_full_f32(fn, form, dataset_blocks,
                                              monkeypatch):
    """The explicit-S contraction ``A @ G^T`` (``_mm_f32``) and the dense
    solve's Cholesky run with TF32 off when the caller allowed it, and the
    caller's setting comes back after, as the reference pins
    ``Precision.HIGHEST`` itself (``libwave_tpu/optim/schur.py:831-843``)."""
    problem, _, bt = dataset_blocks
    n, m = bt.Hpp.shape[0], bt.bl.shape[-1]
    kw, _ = _form_kw(form, problem, n, m)
    seen = []
    real_mm, real_chol = ts._mm_f32, ts.chol_solve_mixed
    real_drs = ts.dense_reduced_system

    def mm_spy(a, g):
        seen.append(("mm", precision.tf32_enabled(), _matmul_setting()))
        return real_mm(a, g)

    def chol_spy(*args):
        seen.append(("chol", precision.tf32_enabled(), _matmul_setting()))
        return real_chol(*args)

    monkeypatch.setattr(ts, "_mm_f32", mm_spy)
    monkeypatch.setattr(ts, "chol_solve_mixed", chol_spy)
    with _tf32_allowed():
        before = _matmul_setting()
        assert precision.tf32_enabled()
        if fn == "dense_reduced_system":
            ts.dense_reduced_system(bt, **kw)
        else:
            # the solve builds S through the G/A route the form names
            monkeypatch.setattr(ts, "dense_reduced_system",
                                functools.partial(real_drs, **kw))
            ts.dense_schur_solve(bt, ts.schur_rhs(bt))
        assert _matmul_setting() == before and precision.tf32_enabled()
    want = {"mm"} if fn == "dense_reduced_system" else {"mm", "chol"}
    assert {s[0] for s in seen} == want
    assert not any(s[1] for s in seen), seen
