"""Parity of libwave_tpu_torch.geography.world_frame with libwave_tpu's, at
f64 on the same numpy inputs: LLH from the same ECEF within 1e-9, and
through each package's own ECEF within 1e-9 degrees and 1e-6 m of height;
ECEF and ENU points in metres within 1e-6, the transforms' rotations
within 1e-9 and origins within 1e-6 m; and
every case of tests/test_geography.py on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geography import world_frame as jwf
from libwave_tpu_torch.geography import world_frame as twf

WATERLOO = [43.472285, -80.544858, 329.0]


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def close_llh(t, j):
    """Latitude and longitude within 1e-9 degrees, the height (metres,
    through ECEF coordinates of ~6.4e6 m) within 1e-6."""
    close(t[..., :2], np.asarray(j)[..., :2], 1e-9)
    close(t[..., 2], np.asarray(j)[..., 2], 1e-6)


@pytest.fixture
def llh(rng):
    return np.stack([rng.uniform(-85, 85, 64), rng.uniform(-180, 180, 64),
                     rng.uniform(-100, 9000, 64)], axis=-1)


def test_ecef_and_back_match_jax(llh):
    ecef_t = twf.ecef_point_from_llh(t64(llh))
    close(ecef_t, jwf.ecef_point_from_llh(jnp.asarray(llh)), 1e-6)
    back_t = twf.llh_point_from_ecef(ecef_t)
    close(back_t, jwf.llh_point_from_ecef(jnp.asarray(ecef_t.numpy())), 1e-9)
    close_llh(back_t, jwf.llh_point_from_ecef(
        jwf.ecef_point_from_llh(jnp.asarray(llh))))
    close(back_t[:, :2], llh[:, :2], 1e-9)  # test_roundtrip
    close(back_t[:, 2], llh[:, 2], 1e-6)
    assert back_t.dtype == torch.float64


@pytest.mark.parametrize("datum_is_llh", [True, False])
def test_transforms_match_jax(rng, datum_is_llh):
    datum = np.asarray(WATERLOO)
    if not datum_is_llh:
        datum = np.asarray(jwf.ecef_point_from_llh(jnp.asarray(datum)))
    for fj, ft in ((jwf.enu_from_ecef_transform,
                    twf.enu_from_ecef_transform),
                   (jwf.ecef_from_enu_transform,
                    twf.ecef_from_enu_transform)):
        Tj = np.asarray(fj(jnp.asarray(datum), datum_is_llh))
        Tt = ft(t64(datum), datum_is_llh)
        close(Tt[:, :3], Tj[:, :3], 1e-9)  # rotation
        close(Tt[:3, 3], Tj[:3, 3], 1e-6)  # origin in metres
        close(Tt[3], [0, 0, 0, 1], 0.0)
    pts = rng.uniform(-2000, 2000, (32, 3))
    close_llh(twf.llh_point_from_enu(t64(pts), t64(datum), datum_is_llh),
              jwf.llh_point_from_enu(jnp.asarray(pts), jnp.asarray(datum),
                                     datum_is_llh))
    llh = np.asarray(WATERLOO) + rng.uniform(-0.01, 0.01, (32, 3))
    close(twf.enu_point_from_llh(t64(llh), t64(datum), datum_is_llh),
          jwf.enu_point_from_llh(jnp.asarray(llh), jnp.asarray(datum),
                                 datum_is_llh), 1e-6)


def test_batched_datums_match_jax(rng):
    datums = np.asarray(WATERLOO) + rng.uniform(-5, 5, (4, 3))
    close(twf.enu_from_ecef_transform(t64(datums))[..., :3, :3],
          np.asarray(jwf.enu_from_ecef_transform(jnp.asarray(datums)))[
              ..., :3, :3], 1e-9)


def test_known_points():
    close(twf.ecef_point_from_llh(t64([0.0, 0.0, 0.0])),
          [6378137.0, 0.0, 0.0], 1e-6)
    close(twf.ecef_point_from_llh(t64([90.0, 0.0, 0.0])),
          [0.0, 0.0, 6356752.314245], 1e-4)


def test_enu_cases():
    w = t64(WATERLOO)
    close(twf.enu_point_from_llh(w, w), [0.0, 0.0, 0.0], 1e-6)
    T1 = twf.enu_from_ecef_transform(w)
    T2 = twf.ecef_from_enu_transform(w)
    close(T1 @ T2, np.eye(4), 1e-6)
    enu = twf.enu_point_from_llh(w + t64([0.001, 0.0, 0.0]), w)
    assert abs(float(enu[0])) < 1.0 and 100.0 < float(enu[1]) < 120.0
    assert abs(float(enu[2])) < 1.0
    # a datum given as a list is taken in the points' dtype and device
    close(twf.enu_point_from_llh(w, WATERLOO), [0.0, 0.0, 0.0], 1e-6)
    datum_ecef = twf.ecef_point_from_llh(w)
    close(twf.enu_point_from_llh(w, datum_ecef, datum_is_llh=False),
          [0.0, 0.0, 0.0], 1e-5)


def test_enu_llh_roundtrip(rng):
    pts = t64(rng.uniform(-2000, 2000, (16, 3)))
    back = twf.enu_point_from_llh(twf.llh_point_from_enu(pts, WATERLOO),
                                  WATERLOO)
    close(back, pts.numpy(), 1e-5)


def test_float32_stays_float32(llh):
    out = twf.llh_point_from_ecef(twf.ecef_point_from_llh(
        torch.as_tensor(llh, dtype=torch.float32)))
    assert out.dtype == torch.float32


def test_host_inputs_take_the_device_argument(llh):
    """Lists and numpy arrays go to ``device`` (here the CPU) and give what
    the same tensors give; with ``device=None`` they go to the card, so
    without one they raise rather than run on the CPU."""
    for fn in (twf.enu_from_ecef_transform, twf.ecef_from_enu_transform):
        T = fn(WATERLOO, device="cpu")
        assert T.dtype == torch.float64
        close(T, fn(t64(WATERLOO)), 0.0)
    close(twf.ecef_point_from_llh(llh, device="cpu"),
          twf.ecef_point_from_llh(t64(llh)).numpy(), 0.0)
    pts = llh[:8, :3] * [1e-3, 1e-3, 1.0]
    enu = twf.enu_point_from_llh(pts, WATERLOO, device="cpu")
    close(enu, twf.enu_point_from_llh(t64(pts), WATERLOO).numpy(), 0.0)
    close(twf.llh_point_from_enu(enu.numpy(), WATERLOO, device="cpu"),
          twf.llh_point_from_enu(enu, WATERLOO).numpy(), 0.0)
    if torch.cuda.is_available():
        assert twf.enu_from_ecef_transform(WATERLOO).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            twf.enu_from_ecef_transform(WATERLOO)
