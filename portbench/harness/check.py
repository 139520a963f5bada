"""The comparison that decides ``correct``.

A solve's answer is its final state and the costs it reports. The plain
reference (:mod:`portbench.reference.ba_ref`) solves the same raw problem
from the same start with the same settings, and four numbers compare the
two, each against a limit of the cell's (``portbench/limits/<cell>.json``):

- ``cost_gap``: |E(answer) - E(reference)| / E(reference), where E is the
  float64 cost of a state over every observation. It judges the state,
  whatever route produced it: linearization, the reduced system and its
  kernels, PCG, back substitution, the retraction and acceptance all move
  it.
- ``reported_gap``: |reported final cost - E(answer)| / E(answer): the
  cost the solve reports is the cost of the state it returns.
- ``trajectory_gap``: the largest relative gap between the answer's
  accepted cost after each LM iteration and the reference's: every
  iteration, not only the last, follows the reference.
- ``state_gap``: the state itself against the reference's, part by part
  (orientations, positions, points): the norm of the answer's difference
  from the reference's state over the norm of the reference's move from
  the start, the largest of the three. The gauge is the problem's own (its
  first cameras are held fixed), so the two states compare directly. Near
  a minimum the cost moves with the square of a state error; this number
  moves with the error itself.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ba_ref

NAMES = ("cost_gap", "reported_gap", "trajectory_gap", "state_gap")


def observations(scene) -> ba_ref.Observations:
    """The raw problem of ``scene``, as the reference takes it."""
    return ba_ref.Observations(
        cam=scene.cam.long(), pt=scene.pt.long(), uv=scene.uv,
        intrinsics=scene.intrinsics, free=scene.free,
        num_cameras=scene.num_cameras, num_points=scene.num_points)


def reference_solve(scene, settings: dict, rounding=ba_ref.exact):
    """The reference's answer for ``scene`` from its start state:
    ``(q, p, X, reported final cost, per-iteration costs)``."""
    if settings.get("huber_delta") is not None:
        raise ValueError("the reference solves plain least squares; the "
                         "configuration asks for a Huber loss")
    obs = observations(scene)
    q, p, X, info = ba_ref.solve(obs, scene.q0, scene.p0, scene.X0,
                                 ba_ref.Settings.from_dict(settings),
                                 rounding)
    return q, p, X, info["costs"][-1], info["costs"]


def _quat_gap(a, b):
    """Per camera, the distance of quaternions ``a`` and ``b`` up to sign."""
    return torch.minimum((a - b).norm(dim=-1), (a + b).norm(dim=-1))


def state_gap(scene, answer, reference) -> float:
    """``state_gap`` of ``answer`` against ``reference`` (see above)."""
    f64 = torch.float64
    q, p, X = (t.to(f64).cpu() for t in answer[:3])
    rq, rp, rX = (t.to(f64).cpu() for t in reference[:3])
    q0, p0, X0 = (t.to(f64).cpu() for t in (scene.q0, scene.p0, scene.X0))
    parts = (
        (_quat_gap(q, rq), _quat_gap(q0, rq)),
        ((p - rp).norm(dim=-1), (p0 - rp).norm(dim=-1)),
        ((X - rX).norm(dim=-1), (X0 - rX).norm(dim=-1)),
    )
    return float(torch.stack([d.norm() / m.norm() for d, m in parts]).max())


def readings(scene, answer, reference) -> dict:
    """The compared numbers of ``answer`` against ``reference``, each a
    tuple ``(q, p, X, reported final cost, per-iteration costs)``."""
    obs = observations(scene)
    q, p, X, reported, costs = answer
    rq, rp, rX, _, rcosts = reference
    dev = scene.cam.device
    e_ans = ba_ref.exact_cost(obs, q.to(dev), p.to(dev), X.to(dev))
    e_ref = ba_ref.exact_cost(obs, rq, rp, rX)
    traj = max((abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(costs, rcosts)), default=math.inf)
    if len(costs) != len(rcosts):
        traj = math.inf
    return {
        "cost_gap": abs(e_ans - e_ref) / e_ref,
        "reported_gap": abs(float(reported) - e_ans) / e_ans,
        "trajectory_gap": traj,
        "state_gap": state_gap(scene, answer, reference),
    }


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, lines)``: correct when every number is finite and within
    its limit; one line per number with its limit."""
    lines, ok = [], True
    for name in NAMES:
        v, lim = values[name], limits[name]
        good = math.isfinite(v) and v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines


def answer_of(state, info) -> tuple:
    """A port solve's answer on the host: (q, p, X, reported final cost,
    per-iteration costs)."""
    return (state.q.detach().cpu(), state.p.detach().cpu(),
            state.lm.detach().cpu(), float(info["final_cost"]),
            [float(c) for c in info["costs"].cpu()])


def free_device_memory():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
