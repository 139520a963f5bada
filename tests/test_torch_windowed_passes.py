"""Windowed VIO against the JAX package, on the CPU at f64: two passes
(iterated fixed-lag smoothing, the seam-aligned tail init).

The sequence and the window settings are ``test_torch_windowed_vio.py``'s
(12 s at 5 Hz, 150 landmarks, seed 0, written by the JAX package;
``window=20, overlap=5``, chunks of 4 LM iterations, at most 3). Window
costs within rtol 1e-9, keyframe positions within 1e-8 m and ATE within
1e-9 m, as there.
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
    root = str(tmp_path_factory.mktemp("wvio_passes"))
    jsim.generate_euroc_sequence(root, jsim.EurocSimParams(**SIM), seed=0)
    return root


def test_two_passes_match_reference(root):
    j, t = run_both(root, wparams=dict(passes=2))
    assert_chains_agree(j, t)
    rep = t[1]
    assert rep["passes"] == 2 and rep["completed"]
    # the window-march rate counts both passes' keyframes, the sequence
    # rate divides them back out
    np.testing.assert_allclose(rep["sequence_keyframes_per_s"] * 2,
                               rep["solve_keyframes_per_s"])
    assert len(rep["window_iterations"]) == 2 * rep["num_windows"]
