"""Carry a problem and state from the JAX package into the port.

:func:`from_jax_numpy` takes ``libwave_tpu``'s ``BAProblem``/``BAState``
after their array leaves were converted to numpy (on the JAX side,
``jax.tree.map(np.asarray, (problem, state))``) and returns the port's
containers on ``device``. It reads fields by name and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from libwave_tpu_torch.optim import pose_graph, schur
from libwave_tpu_torch.optim.ba import BAProblem, BAState


def _tensor(x, device, dtype):
    if x is None:
        return None
    t = torch.tensor(np.asarray(x), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_jax_numpy(problem, state, device, dtype=None):
    """Port ``(problem, state)`` to ``(BAProblem, BAState)`` tensors on
    ``device``. Integer fields keep their dtype; floating fields keep
    theirs unless ``dtype`` is given. ``ell``, ``bands``, ``between``,
    ``priors`` and the marginal-prior fields come across when present."""

    def t(x):
        return _tensor(x, device, dtype)

    ell = None
    if problem.ell is not None:
        e = problem.ell
        ell = schur.EllLayout(
            sigma=t(e.sigma), shift_masks=t(e.shift_masks),
            seg_last=t(e.seg_last), has_obs=t(e.has_obs),
        )
    between = None
    if problem.between is not None:
        b = problem.between
        between = pose_graph.BetweenBank(
            i=t(b.i), j=t(b.j), dq=t(b.dq), dp=t(b.dp),
            sqrt_info=t(b.sqrt_info),
        )
    priors = None
    if problem.priors is not None:
        p = problem.priors
        priors = pose_graph.PriorBank(
            i=t(p.i), q=t(p.q), p=t(p.p), sqrt_info=t(p.sqrt_info)
        )
    bands = None
    if problem.bands is not None:
        bands = schur.BandPlan(entries=tuple(problem.bands.entries))
    ported = BAProblem(
        K=t(problem.K), pose_idx=t(problem.pose_idx), lm_idx=t(problem.lm_idx),
        uv=t(problem.uv), weight=t(problem.weight),
        free_pose=t(problem.free_pose), between=between, priors=priors,
        ell=ell, prior_Lambda=t(problem.prior_Lambda),
        prior_b=t(problem.prior_b), prior_q=t(problem.prior_q),
        prior_p=t(problem.prior_p), bands=bands,
    )
    return ported, BAState(q=t(state.q), p=t(state.p), lm=t(state.lm))
