"""Parity of libwave_tpu_torch.sim.vo_dataset with libwave_tpu.sim.vo_dataset
at f64: given the JAX package's landmarks, the robot poses match to 1e-12,
the visibility masks and camera triggers are identical, and the pixels of
visible landmarks match to 1e-10 relative (sin/cos of two libraries along
a 300-step Euler recurrence). The directory format is exact: each package
reads what the other writes to the same arrays, exported directories (no
``landmarks.dat``, truncated rows, ids past the table) included."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from libwave_tpu.sim import vo_dataset as jvo
from libwave_tpu_torch.interop import vo_dataset_from_jax_numpy
from libwave_tpu_torch.sim import vo_dataset as tvo

CONFIGS = [
    dict(nb_landmarks=30, steps=100, hz=10.0, fx=200.0, fy=200.0),
    dict(nb_landmarks=50, steps=300),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_same_landmarks_same_dataset(kw):
    dj = jvo.generate_vo_dataset(jvo.VoSimParams(**kw), jax.random.key(5))
    dt = tvo.generate_vo_dataset(tvo.VoSimParams(**kw),
                                 landmarks=np.asarray(dj.landmarks),
                                 device="cpu")
    assert dt.robot_p_GB.dtype == torch.float64
    for f in ("landmarks", "camera_K", "times"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)))
    for f in ("robot_p_GB", "robot_q_GB"):
        np.testing.assert_allclose(getattr(dt, f).numpy(),
                                   np.asarray(getattr(dj, f)),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(dt.frame_has_obs.numpy(),
                                  np.asarray(dj.frame_has_obs))
    vis = np.asarray(dj.visible)
    np.testing.assert_array_equal(dt.visible.numpy(), vis)
    assert vis.any()
    np.testing.assert_allclose(dt.pixels.numpy()[vis],
                               np.asarray(dj.pixels)[vis], rtol=1e-10)
    assert dt.num_frames == dj.num_frames


def test_params_landmarks_and_checks():
    jp, tp = jvo.VoSimParams(), tvo.VoSimParams()
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    np.testing.assert_array_equal(tp.K(device="cpu").numpy(),
                                  np.asarray(jp.K()))
    np.testing.assert_allclose(tvo.q_BC(device="cpu").numpy(),
                               np.asarray(jvo.q_BC()), rtol=1e-15)
    p = tvo.VoSimParams(nb_landmarks=500)
    lm = tvo.draw_landmarks(p, seed=1)
    assert lm.shape == (500, 3)
    for k, (lo, hi) in enumerate((p.landmark_x_bounds, p.landmark_y_bounds,
                                  p.landmark_z_bounds)):
        assert lo <= lm[:, k].min() and lm[:, k].max() <= hi
    np.testing.assert_array_equal(lm, tvo.draw_landmarks(p, seed=1))
    ds = tvo.generate_vo_dataset(tvo.VoSimParams(nb_landmarks=20, steps=50),
                                 seed=1, device="cpu")
    np.testing.assert_array_equal(ds.landmarks.numpy(), tvo.draw_landmarks(
        tvo.VoSimParams(nb_landmarks=20, steps=50), seed=1))
    for bad in (dict(nb_landmarks=0), dict(hz=0.0), dict(dt=-1.0)):
        with pytest.raises(ValueError):
            tvo.generate_vo_dataset(tvo.VoSimParams(**bad), device="cpu")


def _jax_dataset(kw, seed=5):
    return jvo.generate_vo_dataset(jvo.VoSimParams(**kw), jax.random.key(seed))


def _assert_same(dt, dj):
    """The port's dataset (tensors) equals the JAX package's (arrays)."""
    for f in tvo.VoDataset._fields:
        got, want = getattr(dt, f).cpu().numpy(), np.asarray(getattr(dj, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("kw", CONFIGS)
def test_directory_round_trip_across_packages(tmp_path, kw):
    """The JAX package's ``save_vo_dataset`` read by the port's
    ``load_vo_dataset`` gives the JAX package's own load of it, and the
    port's save of that read gives the same arrays back to both loaders.
    Exact: both write Python's shortest repr of each float64."""
    dj = _jax_dataset(kw)
    jvo.save_vo_dataset(dj, str(tmp_path / "jax"))
    want = jvo.load_vo_dataset(str(tmp_path / "jax"))
    got = tvo.load_vo_dataset(str(tmp_path / "jax"), device="cpu")
    _assert_same(got, want)
    assert got.visible.any() and got.num_frames == int(
        np.asarray(dj.frame_has_obs).sum())
    tvo.save_vo_dataset(got, str(tmp_path / "port"))
    _assert_same(tvo.load_vo_dataset(str(tmp_path / "port"), device="cpu"),
                 want)
    _assert_same(got, jvo.load_vo_dataset(str(tmp_path / "port")))
    # the port's generator, written by the port, read by the JAX package
    dt = tvo.generate_vo_dataset(tvo.VoSimParams(**kw),
                                 landmarks=np.asarray(dj.landmarks),
                                 device="cpu")
    tvo.save_vo_dataset(dt, str(tmp_path / "gen"))
    _assert_same(tvo.load_vo_dataset(str(tmp_path / "gen"), device="cpu"),
                 jvo.load_vo_dataset(str(tmp_path / "gen")))
    # the same dataset written by both packages: the same text
    tvo.save_vo_dataset(vo_dataset_from_jax_numpy(
        jax.tree.map(np.asarray, dj), device="cpu"), str(tmp_path / "same"))
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert ((tmp_path / "same" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    f32 = tvo.load_vo_dataset(str(tmp_path / "gen"), dtype=torch.float32,
                              device="cpu")
    assert f32.pixels.dtype == torch.float32 and f32.visible.dtype == torch.bool


def _exported(root, frames, landmarks=None):
    """A directory as an exported drive writes it: ``frames`` is a list of
    (declared count, rows) with rows "id u v" strings."""
    os.makedirs(root)
    with open(os.path.join(root, "calib.dat"), "w") as f:
        f.write("200 0 100 0 200 80 0 0 1\n")
    if landmarks is not None:
        with open(os.path.join(root, "landmarks.dat"), "w") as f:
            f.write("".join(f"{i} {x} {y} {z}\n"
                            for i, (x, y, z) in landmarks))
    with open(os.path.join(root, "index.dat"), "w") as idx:
        for n, (count, rows) in enumerate(frames):
            with open(os.path.join(root, f"observed_{n}.dat"), "w") as f:
                f.write(f"{0.1 * n}\n{n} {2 * n} 0.5\n0 0 0.6 0.8\n{count}\n"
                        + "".join(r + "\n" for r in rows))
            idx.write(f"observed_{n}.dat\n")


EXPORTS = {
    # no landmarks.dat: the table sized from the largest id; frame 1
    # declares 4 rows and holds 2 and the id of a third
    "no landmarks.dat": dict(frames=[
        (2, ["3 10.5 20.25", "7 1.0 2.0"]),
        (4, ["0 5 6", "11 7.5 8.5", "12"]),
        (0, []),
    ]),
    # landmarks.dat with ids 0-4: ids >= 5 are dropped
    "ids past the table": dict(frames=[
        (3, ["1 10 20", "4 11 21", "9 12 22"]),
        (2, ["2 30 40", "5 31 41"]),
    ], landmarks=[(i, (i, -i, 0.5 * i)) for i in range(5)]),
}


@pytest.mark.parametrize("case", sorted(EXPORTS))
@pytest.mark.parametrize("num_landmarks", [None, 8])
def test_exported_directory_loads_as_jax_package(tmp_path, case,
                                                 num_landmarks):
    root = str(tmp_path / "export")
    _exported(root, **EXPORTS[case])
    want = jvo.load_vo_dataset(root, num_landmarks=num_landmarks)
    got = tvo.load_vo_dataset(root, num_landmarks=num_landmarks,
                              device="cpu")
    _assert_same(got, want)
    if case == "no landmarks.dat" and num_landmarks is None:
        assert got.landmarks.shape == (13, 3)  # id 12 of the cut row counts
        assert not got.visible[1, 12] and got.visible[1, 11]
