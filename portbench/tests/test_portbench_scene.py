"""The scene generator: exact counts, tracks of consecutive cameras, point
ids in mapper order, every observation in front of its camera and inside
the image, the same sparsity for every seed."""

import numpy as np
import torch

from conftest import tiny_config
from portbench.harness import scene as S

TRAFFIC = {"pixel_noise_px": 1.0, "landmark_perturb_of_depth": 0.01,
           "pose_rotation_perturb_deg": 0.2,
           "pose_position_perturb_of_spacing": 0.01}


def test_track_structure_counts_and_order():
    start, length = S.track_structure(356, 226_730, 1_255_268, 24, 0)
    assert length.sum() == 1_255_268
    assert length.min() >= 2 and length.max() <= 24
    assert np.all(np.diff(start) >= 0)  # ids ordered by first camera
    cam, pt = S.observations(start, length, 356)
    assert cam.shape == pt.shape == (1_255_268,)
    # each point's cameras are consecutive around the ring
    first = np.searchsorted(pt, np.arange(226_730))
    assert np.all(cam[first] == start)
    step = (np.diff(cam.astype(np.int64)) % 356)[np.diff(pt) == 0]
    assert np.all(step == 1)


def test_scene_visibility_and_seed(cpu):
    cfg = tiny_config()
    a = S.make_scene(cfg, TRAFFIC, 2**40 + 3, cpu)
    b = S.make_scene(cfg, TRAFFIC, 2**40 + 3, cpu)
    c = S.make_scene(cfg, TRAFFIC, 7, cpu)
    assert a.num_observations == cfg["observations"]
    assert torch.equal(a.uv, b.uv) and torch.equal(a.X0, b.X0)
    assert torch.equal(a.cam, c.cam) and torch.equal(a.pt, c.pt)
    assert not torch.equal(a.uv, c.uv)
    assert a.max_camera_observations == c.max_camera_observations
    # the start state's points are in front of every camera that sees them
    pc = S.camera_frame(a.q0[a.cam.long()].double(),
                        a.p0[a.cam.long()].double(),
                        a.X0[a.pt.long()].double())
    assert bool((pc[:, 2] > 0.5).all())
    W, H = cfg["scene"]["image_width"], cfg["scene"]["image_height"]
    assert bool(((a.uv[:, 0] > -5) & (a.uv[:, 0] < W + 5)
                 & (a.uv[:, 1] > -5) & (a.uv[:, 1] < H + 5)).all())
    assert torch.equal(a.free[:2], torch.zeros(2)) and bool(a.free[2:].all())


def test_scene_refuses_tracks_wider_than_a_view(cpu):
    cfg = tiny_config()
    cfg["scene"]["max_track"] = 40
    try:
        S.make_scene(cfg, TRAFFIC, 1, cpu)
    except ValueError as e:
        assert "max_track" in str(e)
    else:
        raise AssertionError("a track wider than a camera's view was made")
