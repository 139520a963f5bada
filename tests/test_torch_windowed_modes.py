"""Windowed VIO's other modes against the JAX package, on the CPU at f64:
"exclusive" boundary observations and the freeze ablation.

The sequence and the window settings are ``test_torch_windowed_vio.py``'s
(12 s at 5 Hz, 150 landmarks, seed 0, written by the JAX package;
``window=20, overlap=5``, chunks of 4 LM iterations, at most 3). Window
costs within rtol 1e-9, keyframe positions within 1e-8 m and ATE within
1e-9 m, as there (measured ~1e-12 and ~1e-11).
"""

import numpy as np
import pytest

from libwave_tpu.sim import euroc_sim as jsim
from test_torch_windowed_vio import (  # noqa: F401
    SIM,
    assert_chains_agree,
    one_torch_thread,
    run_both,
)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wvio_modes"))
    jsim.generate_euroc_sequence(root, jsim.EurocSimParams(**SIM), seed=0)
    return root


def test_exclusive_boundary_matches_reference(root):
    j, t = run_both(root, wparams=dict(boundary_obs="exclusive"))
    assert_chains_agree(j, t)
    assert t[1]["completed"] and t[1]["num_windows"] == 4


def test_freeze_matches_reference(root):
    j, t = run_both(root, wparams=dict(mode="freeze"))
    assert_chains_agree(j, t)
    rep = t[1]
    # freeze mode clamps the last window to end at the sequence's end
    assert rep["mode"] == "freeze" and rep["num_windows"] == 4
    assert rep["marginalization_seconds"] == 0.0
    assert np.isfinite(rep["window_final_costs"]).all()
