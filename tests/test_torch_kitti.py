"""Parity of libwave_tpu_torch.datasets.kitti and libwave_tpu_torch.native
with libwave_tpu's: the velodyne reader, the pose and time readers (poses
as the port's SE3 within 1e-12), and the port's own build of
``native/wave_native.cpp`` (exact kNN, voxel oracle, CSV and PCD readers)
against the JAX package's, with the numpy fallbacks held to the same
answers."""

import numpy as np
import pytest
import torch

from libwave_tpu import native as jnative
from libwave_tpu.datasets import kitti as jkitti
from libwave_tpu_torch import native as tnative
from libwave_tpu_torch.datasets import kitti as tkitti


def test_velodyne(tmp_path, rng):
    pts = rng.normal(size=(1000, 4)).astype(np.float32)
    p = str(tmp_path / "000000.bin")
    pts.tofile(p)
    for mp in (None, 333):
        np.testing.assert_array_equal(tkitti.load_kitti_velodyne(p, mp),
                                      jkitti.load_kitti_velodyne(p, mp))
    (tmp_path / "bad.bin").write_bytes(b"\0" * 6)
    with pytest.raises(ValueError, match="corrupt"):
        tkitti.load_kitti_velodyne(str(tmp_path / "bad.bin"))


@pytest.mark.parametrize("sep", [" ", ","])
def test_poses_and_times(sep, tmp_path, rng):
    from libwave_tpu.geometry import so3
    import jax.numpy as jnp

    n = 7
    qs = rng.normal(size=(n, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    R = np.asarray(so3.quat_to_rot(jnp.asarray(qs)))
    rows = np.concatenate([R, rng.normal(size=(n, 3, 1))], axis=2)
    p = str(tmp_path / "00.txt")
    np.savetxt(p, rows.reshape(n, 12), delimiter=sep)
    got = tkitti.load_kitti_poses(p, device="cpu")
    ref = jkitti.load_kitti_poses(p)
    assert got.t.dtype == torch.float64 and got.q.device.type == "cpu"
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    tp = str(tmp_path / "times.txt")
    np.savetxt(tp, rng.uniform(size=9))
    np.testing.assert_array_equal(tkitti.load_kitti_times(tp),
                                  jkitti.load_kitti_times(tp))


def test_native_build_and_fallbacks(tmp_path, rng, monkeypatch):
    assert tnative.route() == ("native" if jnative.available() else "numpy")
    q = rng.normal(size=(50, 3)).astype(np.float32)
    t = rng.normal(size=(300, 3)).astype(np.float32)
    it, dt = tnative.knn_exact(q, t, 4)
    ij, dj = jnative.knn_exact(q, t, 4)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    pts = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    vt = tnative.voxel_downsample_exact(pts, 0.5)
    np.testing.assert_array_equal(vt, jnative.voxel_downsample_exact(pts,
                                                                      0.5))
    csv = str(tmp_path / "a.csv")
    np.savetxt(csv, rng.normal(size=(6, 3)), delimiter=",", header="a,b,c")
    np.testing.assert_array_equal(tnative.load_csv(csv),
                                  jnative.load_csv(csv))
    pcd = tmp_path / "a.pcd"
    pcd.write_text("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                   "COUNT 1 1 1\nWIDTH 3\nHEIGHT 1\nPOINTS 3\nDATA ascii\n"
                   "1 2 3\n4 5 6\n7 8 9.5\n")
    np.testing.assert_array_equal(tnative.load_pcd(str(pcd)),
                                  jnative.load_pcd(str(pcd)))
    # the numpy fallbacks give the same answers
    native_out = (tnative.knn_exact(q, t, 4), tnative.load_csv(csv),
                  tnative.load_pcd(str(pcd)))
    monkeypatch.setattr(tnative, "load", lambda: None)
    assert tnative.route() == "numpy"
    (i2, d2), c2, p2 = (tnative.knn_exact(q, t, 4), tnative.load_csv(csv),
                        tnative.load_pcd(str(pcd)))
    np.testing.assert_array_equal(i2, native_out[0][0])
    np.testing.assert_allclose(d2, native_out[0][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c2, native_out[1], rtol=1e-15)
    np.testing.assert_array_equal(p2, native_out[2])
    np.testing.assert_allclose(np.sort(tnative.voxel_downsample_exact(
        pts, 0.5), axis=0), np.sort(vt, axis=0), atol=1e-6)
