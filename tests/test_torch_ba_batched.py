"""``libwave_tpu_torch.optim.ba.solve_ba_batched`` (B windows as one
disjoint union) on the CPU at f64.

- Against the JAX package's ``jax.vmap(solve_ba)`` on the same stacked
  windows (``bench.make_problem`` windows of 8 poses and 60 landmarks, as
  ``bench.py``'s ``bench_ba_batched`` builds its 50 x 2,000 ones): costs
  rtol 1e-6, accept flags equal, dense and PCG. One window starts with its
  landmarks metres off and rejects steps that the others accept.
- Against each window's own ``solve_ba`` in the port: rtol 1e-10, accept
  flags and CG iterations equal (measured: bit for bit where the windows
  share one slot width). Also with slot banks of different widths (padded)
  and with odometry and prior banks (``ba_from_dataset`` windows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libwave_tpu.optim import ba as jba
from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.optim import ba as tba
from libwave_tpu_torch.sim import vo_dataset as tvo

B = 3
REJECTING = 1  # the window that rejects steps the others accept
SCALE = 2.5  # its landmarks' offset, m (standard normal directions)
# bench.py's batched configuration, but CG run to convergence (1e-10, at
# most 100 steps; these windows take 43-61): cut at 20 or 40 steps, CG
# leaves a residual in which the two frameworks' summation orders, and the
# JAX package's own single and vmapped solves, part by 1e-5 to 3e-3 in cost
CFG = dict(max_iterations=8, cg_max_iters=100, cg_tol=1e-10,
           relative_decrease_tol=0.0, absolute_decrease_tol=0.0)
# bench.py's batched configuration, shortened
PADDED_CFG = dict(max_iterations=5, cg_max_iters=20, cg_tol=1e-5,
                  relative_decrease_tol=0.0, absolute_decrease_tol=0.0)
SOLVERS = {"dense": dict(solver="dense", dense_max_landmarks=100_000),
           "pcg": dict()}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def windows():
    """B windows at f64 as (JAX problem, JAX state, port problem, port
    state): ``bench.make_problem`` and the port's bit-identical
    ``bench_problem.make_problem`` (whose layout leaves the zero-weight
    slots out of every landmark's run), bands dropped (neither package
    takes the explicit-S path on the CPU), window REJECTING's landmarks
    moved SCALE m off."""
    out = []
    noise = np.random.default_rng(0).normal(size=(60, 3))
    for i in range(B):
        kw = dict(num_poses=8, num_landmarks=60, obs_per_pose=30, seed=10 + i)
        pr, st = bench.make_problem(**kw)
        pr, st = _f64(pr._replace(bands=None)), _f64(st)
        pt, s_t = bench_problem.make_problem(**kw, device="cpu")
        pt = pt._replace(bands=None, **{f: getattr(pt, f).double() for f in (
            "K", "uv", "weight", "free_pose")})
        s_t = tba.BAState(*(x.double() for x in s_t))
        if i == REJECTING:
            st = st._replace(lm=st.lm - 0.1 + SCALE * noise)
            s_t = s_t._replace(lm=s_t.lm - 0.1 + SCALE * torch.as_tensor(
                noise))
        np.testing.assert_array_equal(s_t.lm.numpy(), np.asarray(st.lm))
        out.append((pr, st, pt, s_t))
    smax = max(w[0].ell.shift_masks.shape[0] for w in out)

    def pad(p):  # bench.py's stacking: equal shift-pass counts
        sm = p.ell.shift_masks
        sm = jnp.concatenate([sm, jnp.zeros((smax - sm.shape[0],)
                                            + sm.shape[1:], sm.dtype)])
        return p._replace(ell=p.ell._replace(shift_masks=sm))

    return [(pad(w[0]),) + w[1:] for w in out]


def _own_solves(problems, states, cfg):
    return [tba.solve_ba(p, s, cfg) for p, s in zip(problems, states)]


def _held_to_own(out, info, own, rtol, floor=0.0, state_atol=1e-12):
    """Each window against its own solve: costs within ``rtol`` (and
    ``floor`` times the initial cost, where the cost reaches rounding),
    states within ``rtol`` and ``state_atol``."""
    for b, (s1, i1) in enumerate(own):
        atol = floor * float(i1["initial_cost"])
        for k in ("costs", "initial_cost", "final_cost", "final_lambda"):
            np.testing.assert_allclose(info[k][b].numpy(), i1[k].numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)
        for k in ("accepted", "cg_iterations"):
            np.testing.assert_array_equal(info[k][b].numpy(), i1[k].numpy())
        for f in ("q", "p", "lm"):
            np.testing.assert_allclose(getattr(out, f)[b].numpy(),
                                       getattr(s1, f).numpy(), rtol=rtol,
                                       atol=state_atol)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_batched_equals_jax_vmap_and_own_solves(windows, solver):
    jcfg = jba.BAConfig(**CFG, **SOLVERS[solver])
    sp = jax.tree.map(lambda *xs: jnp.stack(xs), *(w[0] for w in windows))
    ss = jax.tree.map(lambda *xs: jnp.stack(xs), *(w[1] for w in windows))
    _, info_j = jax.jit(jax.vmap(lambda p, s: jba.solve_ba(p, s, jcfg)))(
        sp, ss)
    problems, states = [w[2] for w in windows], [w[3] for w in windows]
    cfg = tba.BAConfig(**CFG, **SOLVERS[solver])
    out, info = tba.solve_ba_batched(problems, states, cfg)
    assert out.q.shape == (B, 8, 4) and out.lm.shape == (B, 60, 3)
    assert info["costs"].shape == (B, CFG["max_iterations"])
    np.testing.assert_allclose(info["costs"].numpy(),
                               np.asarray(info_j["costs"]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(info["accepted"].numpy(),
                                  np.asarray(info_j["accepted"]))
    acc = info["accepted"].numpy()
    others = np.arange(B) != REJECTING
    assert (~acc[REJECTING] & acc[others].all(axis=0)).any()
    own = _own_solves(problems, states, cfg)
    _held_to_own(out, info, own, rtol=1e-10)
    # one slot width: the batch computes what each own solve computes
    for b, (s1, i1) in enumerate(own):
        assert torch.equal(info["costs"][b], i1["costs"])
        assert torch.equal(out.lm[b], s1.lm)


def _dataset_windows(flags):
    """B ``ba_from_dataset`` windows of one shape (27 poses, 40 landmarks)
    whose landmarks differ: their slot banks differ in width."""
    params = tvo.VoSimParams(nb_landmarks=40, steps=300, fx=200.0, fy=200.0,
                             hz=10.0)
    problems, states = [], []
    for i in range(B):
        ds = tvo.generate_vo_dataset(params, seed=20 + i, device="cpu")
        pr, gt = tba.ba_from_dataset(ds, **flags, device="cpu")
        rng = np.random.default_rng(i)
        states.append(gt._replace(
            p=gt.p + torch.as_tensor(0.05 * rng.normal(size=gt.p.shape))
            * pr.free_pose[:, None],
            lm=gt.lm + torch.as_tensor(0.3 * rng.normal(size=gt.lm.shape))))
        problems.append(pr)
    return problems, states


@pytest.mark.parametrize("flags", [dict(), dict(with_odometry=True,
                                                with_priors=True)],
                         ids=["vision", "pose_graph"])
def test_padded_windows_with_banks_equal_own_solves(flags):
    problems, states = _dataset_windows(flags)
    widths = {p.lm_idx.shape[0] // p.num_poses for p in problems}
    assert len(widths) > 1  # the union pads
    for solver in sorted(SOLVERS):
        cfg = tba.BAConfig(**PADDED_CFG, **SOLVERS[solver])
        out, info = tba.solve_ba_batched(problems, states, cfg)
        # padded slot sums add the same terms in other groupings, and 20 CG
        # steps carry that on: rtol 1e-10 until the cost reaches 1e-15 of
        # its start, states within 1e-9
        _held_to_own(out, info, _own_solves(problems, states, cfg), 1e-10,
                     floor=1e-15, state_atol=1e-9)
        assert (info["final_cost"] < info["initial_cost"]).all()


def test_windows_of_other_shapes_raise():
    problems, states = _dataset_windows({})
    with pytest.raises(ValueError, match="landmarks"):
        tba.solve_ba_batched(problems, [states[0]._replace(
            lm=states[0].lm[:-1])] + states[1:])
    with pytest.raises(ValueError, match="banks"):
        tba.solve_ba_batched([problems[0], tba.ba_from_dataset(
            tvo.generate_vo_dataset(tvo.VoSimParams(
                nb_landmarks=40, fx=200.0, fy=200.0, hz=10.0), seed=20,
                device="cpu"), with_odometry=True, device="cpu")[0]],
            states[:2])


def test_batched_workload_is_bench_pys():
    """``bench_problem.ba_batched_problems``: ``bench.py``'s
    ``bench_ba_batched`` windows (50 poses, 2,000 landmarks, 240
    observations per pose, seed 10 + i), arrays and band plans equal."""
    problems, states = bench_problem.ba_batched_problems(2, device="cpu")
    for i, (pt, st) in enumerate(zip(problems, states)):
        pj, sj = bench.make_problem(**bench_problem.BATCH_WINDOW_SHAPE,
                                    seed=10 + i)
        assert pt.lm_idx.shape == (12_000,)
        for f in ("pose_idx", "lm_idx", "uv", "weight", "free_pose", "K"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(pj, f)))
        for a, b in zip(st, sj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert pt.bands.entries == tuple(pj.bands.entries)
    cfg_pcg, cfg_dense = bench_problem.batched_configs()
    assert (cfg_pcg.max_iterations, cfg_pcg.cg_max_iters, cfg_pcg.cg_tol,
            cfg_pcg.solver) == (8, 20, 1e-5, "pcg")
    assert (cfg_dense.solver, cfg_dense.dense_max_landmarks) == ("dense",
                                                                  100_000)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_crossings_per_lm_iteration(windows, solver):
    """The segment reduce and broadcast calls of one LM iteration, as
    ``solve_ba_batched``'s docstring states them: 3 and 1 for all B on the
    dense route; matrix-free CG (the CPU's PCG route) adds each window's
    own, 3 + B*cg and 1 + B*(1 + cg), beside a single solve's 3 + cg and
    2 + cg."""
    from unittest import mock

    from libwave_tpu_torch.ops import segmm

    cg = 4
    cfg = tba.BAConfig(**{**PADDED_CFG, "max_iterations": 1,
                          "cg_max_iters": cg}, **SOLVERS[solver])
    problems, states = [w[2] for w in windows], [w[3] for w in windows]
    calls = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    def crossings(solve):
        calls.clear()
        with mock.patch.multiple(
                segmm, seg_reduce_sorted=counted(
                    "reduce", segmm.seg_reduce_sorted),
                seg_broadcast=counted("broadcast", segmm.seg_broadcast)):
            solve()
        return dict(calls)

    one = crossings(lambda: tba.solve_ba(problems[0], states[0], cfg))
    batch = crossings(lambda: tba.solve_ba_batched(problems, states, cfg))
    if solver == "dense":
        assert one == batch == dict(reduce=3, broadcast=1)
    else:
        assert one == dict(reduce=3 + cg, broadcast=2 + cg)
        assert batch == dict(reduce=3 + B * cg, broadcast=1 + B * (1 + cg))
