"""Windowed VIO against the JAX package, on the CPU at f64: two padding
buckets (``pad_percentile=70``).

The sequence and the window settings are ``test_torch_windowed_vio.py``'s
(12 s at 5 Hz, 150 landmarks, seed 0, written by the JAX package;
``window=20, overlap=5``, chunks of 4 LM iterations, at most 3). Frames
[30, 40) get their observations three more times under fresh track ids, as
in the JAX package's own test (``tests/test_windowed_vio.py:233``), so one
window is dense: both packages report the same buckets and the same
windows in each; window costs within rtol 1e-9, keyframe positions within
1e-8 m and ATE within 1e-9 m, as there.
"""

import numpy as np
import pytest

from libwave_tpu.datasets.euroc import load_euroc_tracks
from libwave_tpu.sim import euroc_sim as jsim
from test_torch_windowed_vio import (  # noqa: F401
    SIM,
    assert_chains_agree,
    one_torch_thread,
    run_both,
)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wvio_pad"))
    jsim.generate_euroc_sequence(root, jsim.EurocSimParams(**SIM), seed=0)
    return root


def test_pad_buckets_match_reference(root):
    tracks = np.asarray(load_euroc_tracks(root))
    sel = (tracks[:, 0] >= 30) & (tracks[:, 0] < 40)
    dups = []
    for c in range(3):
        d = tracks[sel].copy()
        d[:, 1] += 100000 * (c + 1)
        dups.append(d)
    dense = np.concatenate([tracks] + dups)
    j, t = run_both(root, wparams=dict(pad_percentile=70.0), tracks=dense)
    assert_chains_agree(j, t)
    rep = t[1]
    assert len(rep["pad_buckets"]) == 2
    small, big = rep["pad_buckets"]
    assert small[0] < big[0]
    assert sum(rep["pad_bucket_windows"]) == rep["num_windows"]
