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
  a recorded flag, exact;
- the matvec's four kernel steps (``ops.segmm``'s matvec wrappers and the
  reduce) run their plain versions on the CPU, and composed they give
  ``schur_matvec``'s numbers bit for bit: the same operations in the same
  order;
- the CG trip (``ops.segmm.pcg_trip_reference``, and ``pcg_trip``'s plain
  in-place version on CPU tensors) against a copy of ``pcg``'s loop body
  as it was written before the trip had a kernel: bit for bit.
"""

import contextlib
import functools
from unittest import mock

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
from libwave_tpu_torch.utils import precision, trace

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


def _port_blocks(lin, rng, layout="ell", D=6, dtype=torch.float64,
                 free_cols=False, axis_name=None):
    """The port's blocks of the ``lin`` bank alone: pose dimension ``D``
    (the observations touch the first 6), random pose-pose couplings, the
    first pose fixed (and, with ``free_cols``, one column of the second:
    free_pose (N, D)), everything in ``dtype``. Pose-ELL padding slots lie
    outside every landmark's run, as ``pack_observations`` leaves them."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    r, Jp, Jl, w = (t(lin[k]) for k in ("r", "J_pose", "J_lm", "w"))
    valid = lin["w"].reshape(-1) > 0
    ell = None
    if layout == "ell":
        ell = ts.build_ell_layout(lin["lm_idx"], M, valid=valid,
                                  device="cpu")
    else:
        r, Jp, Jl = (x.reshape(x.shape[:-2] + (-1,)) for x in (r, Jp, Jl))
        w = w.reshape(-1)
    free = np.ones((N, D) if free_cols else N)
    free[0] = 0.0
    if free_cols:
        free[1, 3] = 0.0
    F = lin["ci"].size
    couplings = (t(rng.normal(size=(F, D, D))), torch.tensor(lin["ci"]),
                 torch.tensor(lin["cj"]))
    return ts.build_normal_equations(
        r, Jp, Jl, w, torch.tensor(lin["pose_idx"]),
        torch.tensor(lin["lm_idx"]), N, M, 1e-3, t(free),
        couplings=couplings, ell=ell, pose_dim=D, axis_name=axis_name)


@pytest.mark.parametrize("D,dtype,free_cols,strided", [
    (6, torch.float64, False, False),
    (6, torch.float32, False, True),
    (6, torch.float32, True, False),
    (15, torch.float32, True, True),
    (15, torch.float64, False, True),
    (15, torch.float32, False, False),
])
def test_fused_matvec_plain_steps_equal_schur_matvec(D, dtype, free_cols,
                                                     strided, lin, rng):
    """``_fused_matvec`` on the CPU (the three matvec wrappers' plain
    versions and the reduce's, composed as on the card) gives
    ``schur_matvec``'s numbers bit for bit: pose-ELL blocks with padding
    slots, D = 6 and 15, free_pose (N,) and (N, D), and W as a batched
    window's strided view (a plane stride of the union's 3 N Pmax)."""
    bt = _port_blocks(lin, rng, D=D, dtype=dtype, free_cols=free_cols)
    assert (bt.W == 0).all(0).any()  # padding slots
    if strided:
        big = torch.zeros((18, 3 * N) + tuple(bt.W.shape[2:]), dtype=dtype)
        big[:, N:2 * N] = bt.W
        bt = bt._replace(W=big[:, N:2 * N])
        assert bt.W.stride(0) == 3 * bt.W.shape[1] * bt.W.shape[2]
    x = torch.as_tensor(rng.normal(size=(N, D)), dtype=dtype)
    with trace.recording() as rec:
        want = ts.schur_matvec(bt, x)
    assert rec.counters["schur.matvec_fused"] == 0
    assert rec.counters["launches.matvec_pose_side"] == 0
    got = ts._fused_matvec(bt, x)
    assert got.dtype == dtype and torch.equal(got, want)
    # the steps one by one against the composition's pieces
    xh = ts._project(x, bt.free_pose)
    t = segmm.matvec_wt_slots(bt.W, x, bt.free_pose)
    assert torch.equal(t, ts._w_t_apply(bt.W, xh.T[:, :, None]).reshape(3, -1))
    utx = ts.ell_seg_reduce(t, bt.lm_order)
    y = segmm.matvec_landmark_step(bt.Hll_inv, utx)
    assert torch.equal(y, ts.sym3_matvec(bt.Hll_inv, utx))


@pytest.mark.parametrize("case", ["card_ell", "cpu", "flat", "sharded",
                                  "f64", "rows"])
def test_matvec_dispatch(case, lin, rng):
    """Which path ``schur_matvec`` takes, read from the ``schur.
    matvec_fused`` counter and the wrappers' launch counts inside a
    recording: only unsharded float32 pose-ELL blocks with 18 W rows on
    the card take the fused path. The card is stood in for by
    ``Tensor.is_cuda`` (the wrappers still see CPU tensors and run their
    plain versions: no launch); every other case, on the card too, takes
    the plain composition. Both give the same numbers."""
    from libwave_tpu_torch.parallel.mesh import Axis

    bt = _port_blocks(
        lin, rng, layout="flat" if case == "flat" else "ell",
        dtype=torch.float64 if case == "f64" else torch.float32,
        axis_name=Axis("dp", 1, 0) if case == "sharded" else None)
    if case == "rows":  # W touching 5 pose coordinates
        bt = bt._replace(W=bt.W[:15])
    x = torch.as_tensor(rng.normal(size=(N, 6)), dtype=bt.bp.dtype)
    card = (contextlib.nullcontext() if case == "cpu" else
            mock.patch.object(torch.Tensor, "is_cuda",
                              new_callable=mock.PropertyMock,
                              return_value=True))
    with card, trace.recording() as rec:
        got = ts.schur_matvec(bt, x)
    assert rec.counters["schur.matvec_fused"] == (case == "card_ell")
    for w in trace.counted_wrappers():
        assert rec.counters[f"launches.{w}"] == 0
    assert torch.equal(got, ts.schur_matvec(bt, x))


def _self_blocks_as_written(blocks):
    """``schur._schur_self_blocks`` as it was written before the
    preconditioner's self-blocks had a kernel: the oracle of the plain
    composition and of the kernel's plain version."""
    W = blocks.W
    Dj = W.shape[0] // 3
    hk = segmm.seg_broadcast(blocks.Hll_inv, blocks.lm_idx)
    if blocks.ell is not None:
        hk = hk.reshape((6,) + tuple(W.shape[1:]))
    at = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 1, (1, 1): 3, (1, 2): 4,
          (2, 0): 2, (2, 1): 4, (2, 2): 5}
    T = [[sum(W[i * 3 + j] * hk[at[(j, l)]] for j in range(3))
          for l in range(3)] for i in range(Dj)]
    pairs = [(i, j) for i in range(Dj) for j in range(i, Dj)]
    self_k = torch.stack([sum(T[i][l] * W[i2 * 3 + l] for l in range(3))
                          for i, i2 in pairs])
    sums = ts._seg_pose(blocks, self_k)
    rows = [[None] * Dj for _ in range(Dj)]
    for c, (i, j) in zip(sums, pairs):
        rows[i][j] = rows[j][i] = c
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@pytest.mark.parametrize("D,dtype,free_cols,strided", [
    (6, torch.float64, False, False),
    (6, torch.float32, False, True),
    (6, torch.float32, True, False),
    (15, torch.float32, True, True),
    (15, torch.float64, False, True),
])
def test_self_blocks_plain_equals_the_sweep_as_written(D, dtype, free_cols,
                                                       strided, lin, rng):
    """The preconditioner's self-blocks on the CPU: ``_schur_self_blocks``
    (its plain composition), ``_plain_self_blocks`` and the kernel
    wrapper's plain version ``segmm.schur_self_blocks`` all give the sweep
    as it was written before, bit for bit: pose-ELL blocks with padding
    slots, D = 6 and 15, f32 and f64, and W as a batched window's strided
    view. No launch, no fused call counted."""
    bt = _port_blocks(lin, rng, D=D, dtype=dtype, free_cols=free_cols)
    if strided:
        big = torch.zeros((18, 3 * N) + tuple(bt.W.shape[2:]), dtype=dtype)
        big[:, N:2 * N] = bt.W
        bt = bt._replace(W=big[:, N:2 * N])
    want = _self_blocks_as_written(bt)
    with trace.recording() as rec:
        got = ts._schur_self_blocks(bt)
    assert rec.counters["schur.precond_fused"] == 0
    assert rec.counters["launches.schur_self_blocks"] == 0
    assert got.shape == (N, 6, 6) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ts._plain_self_blocks(bt), want)
    assert torch.equal(segmm.schur_self_blocks(bt.W, bt.lm_idx, bt.Hll_inv),
                       want)


@pytest.mark.parametrize("case", ["card_ell", "card_window", "cpu", "flat",
                                  "sharded", "f64", "rows"])
def test_preconditioner_dispatch(case, lin, rng):
    """Which path the SCHUR_JACOBI preconditioner's self-blocks take, read
    from ``segmm.takes_self_blocks`` and the ``schur.precond_fused``
    counter inside a recording: only unsharded float32 pose-ELL blocks with
    18 W rows on the card (a batched window's strided view of W too) take
    the kernel. The card is stood in for by ``Tensor.is_cuda`` (the
    wrapper still sees CPU tensors and runs its plain version: no launch);
    the CPU, the flat layout, sharded blocks, f64 and W of 15 rows take the
    plain composition. Every case gives the unpatched preconditioner's
    numbers bit for bit (NaN in the same cells)."""
    from libwave_tpu_torch.parallel.mesh import Axis

    bt = _port_blocks(
        lin, rng, layout="flat" if case == "flat" else "ell",
        dtype=torch.float64 if case == "f64" else torch.float32,
        axis_name=Axis("dp", 1, 0) if case == "sharded" else None)
    if case == "rows":  # W touching 5 pose coordinates
        bt = bt._replace(W=bt.W[:15])
    if case == "card_window":
        big = torch.zeros((18, 3 * N) + tuple(bt.W.shape[2:]))
        big[:, N:2 * N] = bt.W
        bt = bt._replace(W=big[:, N:2 * N])
    card = (contextlib.nullcontext() if case == "cpu" else
            mock.patch.object(torch.Tensor, "is_cuda",
                              new_callable=mock.PropertyMock,
                              return_value=True))
    fused = case in ("card_ell", "card_window")
    with card, trace.recording() as rec:
        takes = segmm.takes_self_blocks(bt.W, bt.lm_idx, bt.Hll_inv)
        got = ts.schur_jacobi_preconditioner(bt)
    assert takes == (fused or case == "sharded")  # sharded: by the layout
    assert rec.counters["schur.precond_fused"] == fused
    for w in trace.counted_wrappers():
        assert rec.counters[f"launches.{w}"] == 0
    # (random blocks: some poses' S blocks are not positive definite and
    # invert to NaN, in the same cells)
    torch.testing.assert_close(got, ts.schur_jacobi_preconditioner(bt),
                               rtol=0, atol=0, equal_nan=True)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _matvec_args():
    """Well-formed arguments of the three matvec wrappers on the meta
    device (no data): N = 4 poses, Pmax = 5, D = 15, M = 7."""
    N_, P, D, M_ = 4, 5, 15, 7
    return dict(
        wt=(_meta(18, N_, P), _meta(N_, D), _meta(N_)),
        step=(_meta(6, M_), _meta(3, M_)),
        pose=(_meta(18, N_, P), _meta(N_ * P, dtype=torch.int32),
              _meta(3, M_), _meta(N_, D, D), _meta(N_, D), _meta(N_, D)),
        self=(_meta(18, N_, P), _meta(N_ * P, dtype=torch.int32),
              _meta(6, M_)),
    )


_WRAPPERS = dict(wt=segmm.matvec_wt_slots, step=segmm.matvec_landmark_step,
                 pose=segmm.matvec_pose_side, self=segmm.schur_self_blocks)

# (wrapper, argument index, replacement, exception, message)
_MATVEC_BAD = [
    ("wt", 0, lambda W: W.double(), TypeError, "float32 W"),
    ("wt", 0, lambda W: W[:12], ValueError, "rows"),
    ("wt", 0, lambda W: W.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError, "planes"),
    ("wt", 1, lambda x: x[:, :5].contiguous(), ValueError, "D >= 6"),
    ("wt", 1, lambda x: x.T.contiguous().T, ValueError, "contiguous"),
    ("wt", 1, lambda x: torch.empty(x.shape), ValueError, "device"),
    ("wt", 2, lambda f: f.double(), TypeError, "free_pose"),
    ("wt", 2, lambda f: f[:3], ValueError, "free_pose"),
    ("step", 0, lambda h: h[:5], ValueError, "hinv"),
    ("step", 1, lambda u: u.double(), TypeError, "utx"),
    ("step", 1, lambda u: u[:, :6], ValueError, "utx"),
    ("pose", 1, lambda i: i.long(), TypeError, "int32"),
    ("pose", 1, lambda i: i[:-1], ValueError, "lm_idx"),
    ("pose", 2, lambda y: y[:2], ValueError, "y must be"),
    ("pose", 3, lambda h: h[:, :6, :6], ValueError, "Hpp"),
    ("pose", 3, lambda h: h.transpose(1, 2), ValueError, "contiguous"),
    ("pose", 4, lambda x: x[:3], ValueError, "x must be"),
    ("self", 0, lambda W: W.double(), TypeError, "float32 W"),
    ("self", 0, lambda W: W[:12], ValueError, "rows"),
    ("self", 0, lambda W: W.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError, "planes"),
    ("self", 1, lambda i: i.long(), TypeError, "int32"),
    ("self", 1, lambda i: i[:-1], ValueError, "lm_idx"),
    ("self", 1, lambda i: torch.empty(i.shape, dtype=i.dtype), ValueError,
     "device"),
    ("self", 2, lambda h: h[:5], ValueError, "Hll_inv"),
    ("self", 2, lambda h: h.double(), TypeError, "Hll_inv"),
    ("self", 2, lambda h: h.T.contiguous().T, ValueError, "contiguous"),
]


@pytest.mark.parametrize("case", range(len(_MATVEC_BAD) + len(_WRAPPERS)))
def test_matvec_wrappers_raise_on_what_the_kernels_do_not_take(case):
    """The matvec wrappers and the preconditioner's self-blocks wrapper
    check every input before a launch and raise on what the kernels do not
    take; well-formed inputs off the CPU and off the card (the meta device)
    pass the checks and raise only for the device."""
    args = _matvec_args()
    if case >= len(_MATVEC_BAD):
        name = list(_WRAPPERS)[case - len(_MATVEC_BAD)]
        with pytest.raises(ValueError, match="unsupported device"):
            _WRAPPERS[name](*args[name])
        return
    name, i, change, exc, msg = _MATVEC_BAD[case]
    bad = list(args[name])
    bad[i] = change(bad[i])
    with pytest.raises(exc, match=msg):
        _WRAPPERS[name](*bad)


def _loop_body(P, free, x, r, p, Sp, rz, rr, thresh_sq, it):
    """``pcg``'s loop body after its matvec as it was written inline,
    before the trip had a kernel: the oracle of the trip's plain version."""
    def vdot(a, b):
        return torch.sum(a * b)

    def apply_P(v):
        return ts._project(ts._einsum("nij,nj->ni", P, ts._project(v, free)),
                           free)

    live = rr > thresh_sq
    denom = vdot(p, Sp)
    alpha = torch.where(live, rz / torch.where(denom == 0, 1.0, denom), 0.0)
    x = x + alpha * p
    r = r - alpha * Sp
    z = apply_P(r)
    rz_new = vdot(r, z)
    rr = vdot(r, r)
    beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
    p = z + beta * p
    rz = torch.where(live, rz_new, rz)
    it = it + live.to(torch.int32)
    return x, r, z, p, rz, rr, it


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("live", [True, False])
@pytest.mark.parametrize("free_cols", [False, True])
@pytest.mark.parametrize("D", [6, 15])
def test_pcg_trip_plain_equals_the_loop_body(D, free_cols, live, rng):
    """``pcg_trip_reference``, and ``pcg_trip``'s in-place trip on CPU
    buffers (composed as on the card: x, r, z, p and a (4,) state holding
    rz, rr, thresh_sq and the int32 it), give the loop body's numbers bit
    for bit over three f32 trips: D = 6 and 15, free_pose (N,) and (N, D),
    live trips and frozen ones (rr below thresh_sq), which leave x, r and
    rz bit-identical. No launch is counted."""
    n = 9

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    G = rng.normal(size=(n, D, D))
    P = t(np.eye(D) + 0.02 * (G + G.transpose(0, 2, 1)))
    free = np.ones((n, D) if free_cols else n)
    free[0] = 0.0
    if free_cols:
        free[1, 3] = 0.0
    free = t(free)
    x, r, p = (t(rng.normal(size=(n, D))) for _ in range(3))
    S = [t(rng.uniform(1.0, 2.0, size=(n, D))) for _ in range(3)]
    rz, rr = torch.sum(r * p), torch.sum(r * r)
    thresh = rr * (1e-6 if live else 2.0)
    it = torch.tensor(4, dtype=torch.int32)
    want = (x, r, None, p, rz, rr, it)
    state = torch.stack([rz, rr, thresh, torch.zeros_like(rz)])
    state.view(torch.int32)[3] = 4
    bufs = [x.clone(), r.clone(), torch.empty_like(x), p.clone()]
    launches = segmm.pcg_trip.launches
    trip = segmm.pcg_trip(P, free, *bufs, state)
    for d in S:
        Sp = want[3] * d  # p . Sp a sum of positive terms
        got = segmm.pcg_trip_reference(P, free, want[0], want[1], want[3],
                                       Sp, want[4], want[5], thresh, want[6])
        want = _loop_body(P, free, want[0], want[1], want[3], Sp, want[4],
                          want[5], thresh, want[6])
        trip(Sp)
        inplace = (*bufs, state[0], state[1], state[3:].view(torch.int32)[0])
        for a, b, c in zip(got, want, inplace):
            assert a.dtype == b.dtype == c.dtype
            assert torch.equal(_bits(a), _bits(b))
            assert torch.equal(_bits(c), _bits(b))
    assert int(want[6]) == (7 if live else 4)
    if not live:
        for a, b in ((want[0], x), (want[1], r), (want[4], rz)):
            assert torch.equal(_bits(a), _bits(b))
    assert segmm.pcg_trip.launches == launches


@pytest.mark.parametrize("case", ["card", "explicit_s", "d15", "cpu", "f64"])
def test_cg_dispatch(case, lin, rng):
    """Which loop ``pcg`` runs, read from the ``schur.cg_fused`` and
    ``schur.cg_trips`` counters inside a recording: float32 vectors on the
    card take the fused trip on every trip, matrix-free, against an
    explicit S and at D = 15; the CPU and float64 take the plain trip on
    none. The card is stood in for by ``Tensor.is_cuda`` (the wrappers see
    CPU tensors and run their plain versions: no launch), and every case
    gives the unpatched CPU solve's numbers bit for bit. The fused loop
    keeps its vectors contiguous, as the kernel takes them, and
    ``torch.sum`` adds in an order that follows its operands' layout (the
    right-hand side ``schur_rhs`` returns is column-major here), so both
    solves start from a contiguous one."""
    bt = _port_blocks(lin, rng, D=15 if case == "d15" else 6,
                      dtype=torch.float64 if case == "f64" else torch.float32)
    S4 = ts.dense_reduced_system(bt) if case == "explicit_s" else None
    b = ts.schur_rhs(bt).contiguous()
    card = (contextlib.nullcontext() if case == "cpu" else
            mock.patch.object(torch.Tensor, "is_cuda",
                              new_callable=mock.PropertyMock,
                              return_value=True))
    with card, trace.recording() as rec:
        got = ts.pcg(bt, b, max_iters=12, tol=1e-10, S4=S4)
    trips = rec.counters["schur.cg_trips"]
    assert trips == 12
    fused = case in ("card", "explicit_s", "d15")
    assert rec.counters["schur.cg_fused"] == (trips if fused else 0)
    # the matrix-free preconditioner's self-blocks through their kernel;
    # explicit S reads its preconditioner off S
    assert rec.counters["schur.precond_fused"] == (case in ("card", "d15"))
    assert rec.counters["launches.pcg_trip"] == 0
    want = ts.pcg(bt, b, max_iters=12, tol=1e-10, S4=S4)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


def _pcg_trip_args(N_=4, D=15):
    """Well-formed arguments of ``pcg_trip`` on the meta device (no
    data): P, free_pose, x, r, z, p, state."""
    return [_meta(N_, D, D), _meta(N_, D), *(_meta(N_, D) for _ in range(4)),
            _meta(4)]


# (argument index, replacement, exception, message)
_PCG_TRIP_BAD = [
    (2, lambda x: _meta(4, 16), ValueError, "D <= 15"),
    (2, lambda x: _meta(4), ValueError, "x must be"),
    (3, lambda r: r[:3], ValueError, "r must be"),
    (5, lambda p: p.double(), TypeError, "p"),
    (4, lambda z: z.T.contiguous().T, ValueError, "contiguous"),
    (0, lambda P: P[:, :6, :6], ValueError, "P must be"),
    (0, lambda P: P.transpose(1, 2), ValueError, "contiguous"),
    (1, lambda f: f[:, :3], ValueError, "free_pose"),
    (1, lambda f: f.double(), TypeError, "free_pose"),
    (6, lambda s: s[:3], ValueError, "state"),
    (6, lambda s: torch.empty(4), ValueError, "device"),
]


@pytest.mark.parametrize("case", range(len(_PCG_TRIP_BAD) + 1))
def test_pcg_trip_raises_on_what_the_kernel_does_not_take(case):
    """``pcg_trip`` checks every operand before it binds a kernel and
    raises on what the kernel does not take; well-formed operands off the
    CPU and off the card (the meta device) pass the checks and raise only
    for the device."""
    args = _pcg_trip_args()
    if case == len(_PCG_TRIP_BAD):
        with pytest.raises(ValueError, match="unsupported device"):
            segmm.pcg_trip(*args)
        return
    i, change, exc, msg = _PCG_TRIP_BAD[case]
    args[i] = change(args[i])
    with pytest.raises(exc, match=msg):
        segmm.pcg_trip(*args)
