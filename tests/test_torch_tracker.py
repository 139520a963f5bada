"""The port's tracker (``libwave_tpu_torch.vision.tracker``) against the JAX
package's.

Both trackers take the JAX package's per-frame keypoint banks, carried
across; without outlier removal every step is integer or copy arithmetic,
so the tracker states are exactly equal, leaf by leaf, after every frame.
Two hand-built frames pin the reference's scatter rule: a valid match to
current keypoint 0 followed by invalid rows (the reference's last-write-wins
loses it), and two previous rows matching one current keypoint (the later
row wins).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import descriptor as js
from libwave_tpu.vision import detector as jd
from libwave_tpu.vision import matcher as jm
from libwave_tpu.vision import tracker as jt
from libwave_tpu_torch import interop
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import tracker as tt
from test_torch_detector import blob_image

_jax_add = jax.jit(jt.add_image_features, static_argnums=(6,))


@jax.jit
def _jax_bank(img):
    xy, _, m = jd.detect_fast(img, jd.FASTParams(num_features=64))
    desc, _ = js.brisk_describe(img, xy, m)
    return xy, desc, m


def _assert_state_equal(st, sj):
    sj = jax.tree.map(np.asarray, sj)
    for f in jt.TrackerState._fields:
        a, b = getattr(st, f), getattr(sj, f)
        if f == "landmarks":
            for g in a._fields:
                np.testing.assert_array_equal(
                    getattr(a, g).numpy(), getattr(b, g), err_msg=g)
        elif f == "prev_desc":
            np.testing.assert_array_equal(interop.desc_to_numpy(a), b)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.fixture(scope="module")
def frame_banks():
    """The JAX package's (xy, desc, mask) banks of 5 frames of a drifting
    blob texture (``tests/test_vision.py``'s tracker sequence)."""
    banks = []
    for i in range(5):
        rng = np.random.default_rng(0)
        img = blob_image(rng, seed_shift=(i * 2.0, i * 3.0))
        banks.append(tuple(np.array(x) for x in _jax_bank(jnp.asarray(img))))
    return banks


@pytest.mark.parametrize("window", [0, 2])
def test_tracker_state_equal_over_five_frames(frame_banks, window):
    jp = jt.TrackerParams(
        window_size=window, num_features=64, buffer_capacity=300,
        matcher=jm.MatcherParams(auto_remove_outliers=False),
    )
    tp = interop.params_from_jax(jp)
    sj = jt.tracker_init(jp, desc_words=16, dtype=jnp.float32)
    st = tt.tracker_init(tp, desc_words=16, device="cpu")
    _assert_state_equal(st, sj)
    for i, (xy, desc, m) in enumerate(frame_banks):
        t = float(i) * 0.1
        sj = _jax_add(sj, jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(m),
                      t, jax.random.key(i), jp)
        st = tt.add_image_features(
            st, torch.from_numpy(xy), interop.desc_from_numpy(desc, "cpu"),
            torch.from_numpy(m), t, None, tp,
        )
        _assert_state_equal(st, sj)
    assert int(st.next_id) >= 10 and int(st.image_count) == 5
    if window:
        imgs = st.landmarks.images[st.landmarks.valid]
        assert int(imgs.min()) >= 3


def _hand_state(prev_words, prev_mask, prev_ids):
    """A JAX TrackerState one frame in, with W = 1 word descriptors."""
    n = len(prev_words)
    jp = jt.TrackerParams(num_features=n, buffer_capacity=32,
                          matcher=jm.MatcherParams(auto_remove_outliers=False))
    s0 = jt.tracker_init(jp, desc_words=1, dtype=jnp.float32)
    sj = s0._replace(
        prev_xy=jnp.asarray(np.arange(2 * n, dtype=np.float32).reshape(n, 2)),
        prev_desc=jnp.asarray(np.asarray(prev_words, np.uint32)[:, None]),
        prev_mask=jnp.asarray(prev_mask),
        prev_ids=jnp.asarray(np.asarray(prev_ids, np.int32)),
        prev_time=jnp.float32(0.5),
        image_count=jnp.int32(1),
        next_id=jnp.int32(13),
    )
    return jp, sj


# distinct words, far apart in Hamming distance
_A, _B, _C, _D, _E, _F = (0x00000000, 0xFFFF0000, 0x0000FFFF, 0xFF00FF00,
                          0x00FF00FF, 0xF0F0F0F0)


@pytest.mark.parametrize("case", ["slot0_loss", "two_rows_one_keypoint"])
def test_hand_built_scatter_rule(case):
    if case == "slot0_loss":
        # valid = [T, F, T, F, F, F], idx2 = [0, ., 2, ...]: the invalid rows
        # after row 0 overwrite current keypoint 0 with -1
        jp, sj = _hand_state([_A, _B, _C, _D, _E, _F],
                             [True, False, True, False, False, False],
                             [10, 11, 12, -1, -1, -1])
        curr = [_A, _D, _C, _E, _F, _B]
        expected = [-1, -1, 12, -1, -1, -1]
    else:
        # previous rows 1 and 3 both match current keypoint 4: row 3 wins;
        # row 3 had no ID, so it mints 13
        jp, sj = _hand_state([_A, _B, _C, _B, _E, _F],
                             [False, True, True, True, False, False],
                             [10, 11, 12, -1, -1, -1])
        curr = [_F, _D, _C, _E, _B, _A]
        expected = [-1, -1, 12, -1, 13, -1]
    n = 6
    xy = np.arange(100, 100 + 2 * n, dtype=np.float32).reshape(n, 2)
    desc = np.asarray(curr, np.uint32)[:, None]
    mask = np.ones(n, bool)
    tp = interop.params_from_jax(jp)
    st = interop.tracker_state_from_jax_numpy(jax.tree.map(np.asarray, sj),
                                              "cpu")
    _assert_state_equal(st, sj)
    sj = jt.add_image_features(sj, jnp.asarray(xy), jnp.asarray(desc),
                               jnp.asarray(mask), 1.0, jax.random.key(0), jp)
    st = tt.add_image_features(st, torch.from_numpy(xy),
                               interop.desc_from_numpy(desc, "cpu"),
                               torch.from_numpy(mask), 1.0, None, tp)
    _assert_state_equal(st, sj)
    assert st.prev_ids.tolist() == expected


def test_offline_tracker_and_get_tracks(frame_banks):
    """``offline_tracker`` (a loop over frames) gives the state of the same
    frames added one by one, and ``get_tracks`` the JAX package's tracks."""
    jp = jt.TrackerParams(num_features=64, buffer_capacity=300,
                          matcher=jm.MatcherParams(auto_remove_outliers=False))
    tp = interop.params_from_jax(jp)
    banks = {i: b for i, b in enumerate(frame_banks[:3])}

    def detect_describe(i):
        xy, desc, m = banks[int(i)]
        return (torch.from_numpy(xy), interop.desc_from_numpy(desc, "cpu"),
                torch.from_numpy(m))

    times = torch.tensor([0.0, 0.1, 0.2])
    st = tt.offline_tracker(detect_describe, torch.arange(3), times, None, tp, 16)
    sj = jt.tracker_init(jp, desc_words=16, dtype=jnp.float32)
    for i, (xy, desc, m) in banks.items():
        sj = _jax_add(sj, jnp.asarray(xy), jnp.asarray(desc), jnp.asarray(m),
                      jnp.float32(times[i]), jax.random.key(i), jp)
    _assert_state_equal(st, sj)
    for lid in range(int(st.next_id)):
        for a, b in zip(tt.get_tracks(st, tp, 4, lid),
                        jt.get_tracks(sj, jp, 4, lid)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scatter_last_wins_rule():
    idx = torch.tensor([0, 3, 0, 3, 5, 0])
    vals = torch.tensor([7, 8, 9, 10, 11, -1], dtype=torch.int32)
    out = tt._scatter_last_wins(idx, vals, 7, -1)
    assert out.tolist() == [-1, -1, -1, 10, -1, 11, -1]


def test_params_defaults_and_validation():
    assert dataclasses.asdict(jt.TrackerParams()) == dataclasses.asdict(
        tt.TrackerParams())
    with pytest.raises(ConfigError):
        validate(tt.TrackerParams(window_size=-1))
