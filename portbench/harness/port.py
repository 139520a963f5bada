"""The system under test: ``libwave_tpu_torch``'s bundle adjustment, reached
through its public entries only (``optim.schur``'s layout functions,
``optim.ba``'s ``BAProblem``, ``BAState``, ``BAConfig`` and ``solve_ba``).

The port is imported inside these functions, so that the harness's own
modules (and its CPU tests of the scene and the reference) load without it.
"""

from __future__ import annotations

import torch

# the settings a configuration's "solver" section and a traffic mix give
# BAConfig, by its own names
SOLVER_KEYS = ("cg_max_iters", "cg_tol", "init_lambda", "lambda_up",
               "lambda_down", "min_lambda", "max_lambda",
               "relative_decrease_tol", "absolute_decrease_tol",
               "huber_delta")


def settings(config: dict, traffic: dict) -> dict:
    """The solve's settings: the configuration's solver section, with the
    traffic mix's LM iterations per solve."""
    s = {k: config["solver"][k] for k in SOLVER_KEYS}
    s["max_iterations"] = traffic["lm_iterations"]
    return s


def build(scene, config: dict, traffic: dict, device):
    """``(problem, state, cfg)`` of the port for ``scene``: the observations
    packed into the port's pose-ELL bank and landmark layout by
    ``schur.pack_observations``, a band plan by ``schur.compute_band_plan``
    where the mix asks for one, and the mix's ``explicit_s`` route."""
    from libwave_tpu_torch.optim import schur
    from libwave_tpu_torch.optim.ba import BAConfig, BAProblem, BAState

    N, M = scene.num_cameras, scene.num_points
    weight = torch.ones(scene.num_observations, dtype=torch.float32,
                        device=device)
    pose_ell, lm_ell, pad_mask, ell, uv, w = schur.pack_observations(
        scene.cam, scene.pt, N, M, scene.uv, weight, device=device)
    bands = (schur.compute_band_plan(lm_ell, pad_mask, N, M)
             if traffic["band_plan"] else None)
    fx, fy, cx, cy = scene.intrinsics
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=device)
    problem = BAProblem(K=K, pose_idx=pose_ell, lm_idx=lm_ell, uv=uv,
                        weight=w, free_pose=scene.free, ell=ell, bands=bands)
    state = BAState(q=scene.q0, p=scene.p0, lm=scene.X0)
    cfg = BAConfig(explicit_s=traffic["explicit_s"],
                   **settings(config, traffic))
    return problem, state, cfg


def solve(problem, state, cfg):
    """One timed call: ``solve_ba`` from ``state``."""
    from libwave_tpu_torch.optim.ba import solve_ba

    return solve_ba(problem, state, cfg)
