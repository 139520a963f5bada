"""The port's spans and counters (``libwave_tpu_torch.utils.trace``) inside
``optim.ba.solve_ba`` and ``solve_ba_batched``, on a tiny problem on the
CPU: what a recording holds, that it changes nothing of the solve, and that
its stamps fall on the profiler's clock."""

from collections import Counter

import pytest
import torch

from libwave_tpu_torch import bench_problem
from libwave_tpu_torch.ops import hamming, segmm
from libwave_tpu_torch.optim import ba
from libwave_tpu_torch.utils import trace

ITERATIONS, CG = 3, 6
CFG = ba.BAConfig(max_iterations=ITERATIONS, cg_max_iters=CG,
                  explicit_s="never")
PER_ITERATION = ("ba.linearize", "schur.rhs", "schur.pcg",
                 "schur.back_substitute", "ba.update")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=3):
    problem, state = bench_problem.make_problem(
        num_poses=8, num_landmarks=200, obs_per_pose=40, seed=seed,
        device="cpu")
    return problem._replace(bands=None), state


def test_spans_nest_with_one_solve_id_per_solve():
    problem, state = _problem()
    with trace.recording() as rec:
        ba.solve_ba(problem, state, CFG)
        ba.solve_ba(problem, state, CFG)
    spans = rec.spans
    names = Counter(s.name for s in spans)
    assert names == Counter({
        "ba.solve": 2, "ba.iteration": 2 * ITERATIONS,
        "ba.cost": 2 * (1 + ITERATIONS),
        "schur.matvec": 2 * ITERATIONS * CG,
        **{n: 2 * ITERATIONS for n in PER_ITERATION}})
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["ba.solve", "ba.solve"]
    assert [spans[i].solve for i in roots] == [0, 1]
    assert spans[roots[0]].attrs == {"iterations": ITERATIONS,
                                     "cg_max_iters": CG}
    parent_of = {"ba.iteration": "ba.solve", "ba.linearize": "ba.iteration",
                 "schur.rhs": "ba.iteration", "schur.pcg": "ba.iteration",
                 "schur.matvec": "schur.pcg",
                 "schur.back_substitute": "ba.iteration",
                 "ba.update": "ba.iteration"}
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.solve == p.solve
        if s.name in parent_of:
            assert p.name == parent_of[s.name]
        else:  # the initial cost under the solve, the trial under an iteration
            assert s.name == "ba.cost" and p.name in ("ba.solve",
                                                      "ba.iteration")
    its = [s for s in spans if s.name == "ba.iteration"]
    assert [s.attrs["i"] for s in its] == list(range(ITERATIONS)) * 2


def test_counters_count_iterations_and_cg_trips():
    problem, state = _problem()
    with trace.recording() as rec:
        ba.solve_ba(problem, state, CFG)
    assert rec.counters["ba.lm_iterations"] == ITERATIONS
    assert rec.counters["schur.cg_trips"] == ITERATIONS * CG
    # every kernel wrapper of ``ops`` is registered as the module's own
    # function (what watches its ``__code__`` sees its calls), and the
    # recording reads each one's launch count: the kernels do not run on
    # the CPU, so nothing launched
    wrappers = trace.counted_wrappers()
    own = {name: fn for mod in (segmm, hamming)
           for name, fn in vars(mod).items()
           if callable(fn) and hasattr(fn, "launches")}
    assert own.keys() == wrappers.keys()
    for name, fn in own.items():
        assert wrappers[name] is fn
        assert f"launches.{name}" in rec.counters
        assert rec.counters[f"launches.{name}"] == 0


def test_nothing_is_recorded_outside_a_recording():
    problem, state = _problem()
    with trace.recording() as rec:
        pass
    ba.solve_ba(problem, state, CFG)
    trace.count("schur.cg_trips", 5)
    assert rec.spans == []
    assert all(v == 0 for v in rec.counters.values())
    assert trace._recording is None
    with trace.recording():
        with pytest.raises(RuntimeError, match="already active"):
            with trace.recording():
                pass


def test_a_recording_leaves_the_solve_bit_identical():
    problem, state = _problem(seed=5)
    s0, i0 = ba.solve_ba(problem, state, CFG)
    with trace.recording():
        s1, i1 = ba.solve_ba(problem, state, CFG)
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    assert i0.keys() == i1.keys()
    for k in i0:
        assert torch.equal(i0[k], i1[k]), k


def test_stamps_are_on_the_profiler_clock():
    problem, state = _problem()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            ba.solve_ba(problem, state, CFG)
    ranges = sorted(ev.start_ns() for ev in
                    prof.profiler.kineto_results.events()
                    if ev.name() == "ba.linearize")
    starts = [s.start_ns for s in rec.spans if s.name == "ba.linearize"]
    assert len(ranges) == len(starts) == ITERATIONS
    for prof_start, start in zip(ranges, starts):
        assert abs(prof_start - start) < 100_000  # 0.1 ms


def test_batched_solve_has_one_iteration_span_per_batched_iteration():
    pairs = [_problem(seed=s) for s in (3, 4)]
    with trace.recording() as rec:
        ba.solve_ba_batched([p for p, _ in pairs], [s for _, s in pairs],
                            CFG)
    names = Counter(s.name for s in rec.spans)
    assert names["ba.solve"] == 1 and names["ba.iteration"] == ITERATIONS
    # each window's reduced system is its own PCG
    assert names["schur.pcg"] == 2 * ITERATIONS
    assert rec.counters["ba.lm_iterations"] == ITERATIONS
    assert rec.counters["schur.cg_trips"] == 2 * ITERATIONS * CG
    assert {s.solve for s in rec.spans} == {0}


def test_packing_records_its_spans_and_slot_counters():
    from libwave_tpu_torch.optim import schur

    # 3 poses seeing 4, 1 and 2 of 5 landmarks: Pmax 4, 12 slots, 5 padded
    pose_idx = torch.tensor([0, 2, 0, 1, 0, 2, 0], dtype=torch.int32)
    lm_idx = torch.tensor([0, 1, 2, 3, 4, 0, 1], dtype=torch.int32)
    uv = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    with trace.recording() as rec:
        packed = schur.pack_observations(pose_idx, lm_idx, 3, 5, uv,
                                         device="cpu")
    assert [s.name for s in rec.spans] == ["schur.pack_observations",
                                           "schur.build_ell_layout"]
    outer, inner = rec.spans
    assert outer.parent is None and inner.parent == 0
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert rec.counters["schur.ell_slots"] == packed[0].shape[0] == 12
    assert rec.counters["schur.ell_padding_slots"] == 12 - 7
    assert int((packed[2] == 0).sum()) == 5

    with trace.recording() as rec:
        pass
    schur.pack_observations(pose_idx, lm_idx, 3, 5, uv, device="cpu")
    assert rec.spans == [] and not rec.counters["schur.ell_slots"]
