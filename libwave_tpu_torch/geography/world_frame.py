"""WGS84 LLH / ECEF / local-ENU conversions (port of
``libwave_tpu.geography.world_frame``).

The reference's wave_geography free functions
(wave_geography/include/wave/geography/world_frame_conversions.hpp:53-122,
src/world_frame_conversions.cpp wrapping GeographicLib::Geocentric::WGS84
and LocalCartesian): ``ecefPointFromLLH``/``llhPointFromECEF``,
``enuFromECEFTransformMatrix``/``ecefFromENUTransformMatrix``,
``enuPointFromLLH``/``llhPointFromENU``.

Closed-form WGS84 ellipsoid math, batched over leading dimensions, in the
caller's dtype. Each function takes ``device=None``: a tensor input stays on
its own device unless ``device`` names one, and a list or numpy array goes
to ``utils.device.resolve(device)``, the card unless the caller asks for
the CPU. The ECEF->LLH inverse is
Bowring's method with a fixed count of 3 iterations (sub-millimetre for
|h| < 100 km). Angles are in degrees at the API, as in the reference.
"""

from __future__ import annotations

import math

import torch

from libwave_tpu_torch.utils.device import as_tensor

# WGS84 ellipsoid
_A = 6378137.0  # semi-major axis [m]
_F = 1.0 / 298.257223563  # flattening
_B = _A * (1.0 - _F)
_E2 = _F * (2.0 - _F)  # first eccentricity squared
_EP2 = _E2 / (1.0 - _E2)  # second eccentricity squared
_DEG = math.pi / 180.0


def _deg2rad(x):
    return x * _DEG


def _rad2deg(x):
    return x * (180.0 / math.pi)


def ecef_point_from_llh(llh, device=None) -> torch.Tensor:
    """(lat_deg, lon_deg, height_m) -> ECEF (x, y, z). Batched (..., 3)."""
    llh = as_tensor(llh, device)
    lat = _deg2rad(llh[..., 0])
    lon = _deg2rad(llh[..., 1])
    h = llh[..., 2]
    sl, cl = torch.sin(lat), torch.cos(lat)
    N = _A / torch.sqrt(1.0 - _E2 * sl * sl)
    x = (N + h) * cl * torch.cos(lon)
    y = (N + h) * cl * torch.sin(lon)
    z = (N * (1.0 - _E2) + h) * sl
    return torch.stack([x, y, z], dim=-1)


def llh_point_from_ecef(ecef, device=None) -> torch.Tensor:
    """ECEF -> (lat_deg, lon_deg, height_m) via Bowring iterations."""
    ecef = as_tensor(ecef, device)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    # Bowring's initial parametric latitude
    theta = torch.atan2(z * _A, p * _B)
    lat = torch.atan2(
        z + _EP2 * _B * torch.sin(theta) ** 3,
        p - _E2 * _A * torch.cos(theta) ** 3,
    )
    for _ in range(3):
        sl = torch.sin(lat)
        N = _A / torch.sqrt(1.0 - _E2 * sl * sl)
        h = p / torch.cos(lat) - N
        lat = torch.atan2(z, p * (1.0 - _E2 * N / (N + h)))
    sl = torch.sin(lat)
    N = _A / torch.sqrt(1.0 - _E2 * sl * sl)
    # height: the more stable of the two expressions by latitude
    h_p = p / torch.cos(lat) - N
    h_z = z / torch.where(torch.abs(sl) < 1e-12, 1.0, sl) - N * (1.0 - _E2)
    h = torch.where(torch.abs(sl) > 0.1, h_z, h_p)
    return torch.stack([_rad2deg(lat), _rad2deg(lon), h], dim=-1)


def _enu_rotation(lat_rad, lon_rad):
    """Rows are ENU axes expressed in ECEF: R maps ECEF deltas -> ENU."""
    sl, cl = torch.sin(lat_rad), torch.cos(lat_rad)
    so_, co = torch.sin(lon_rad), torch.cos(lon_rad)
    zero = torch.zeros_like(sl)
    return torch.stack(
        [
            torch.stack([-so_, co, zero], dim=-1),
            torch.stack([-sl * co, -sl * so_, cl], dim=-1),
            torch.stack([cl * co, cl * so_, sl], dim=-1),
        ],
        dim=-2,
    )


def _as_datum(datum, like: torch.Tensor) -> torch.Tensor:
    """A datum given as a list or array: a tensor in ``like``'s dtype and
    on its device."""
    if isinstance(datum, torch.Tensor):
        return datum
    return torch.as_tensor(datum, dtype=like.dtype, device=like.device)


def _datum_llh(datum, datum_is_llh: bool, device):
    """A datum given as a list or array is taken at f64."""
    dtype = None if isinstance(datum, torch.Tensor) else torch.float64
    datum = as_tensor(datum, device, dtype)
    return datum if datum_is_llh else llh_point_from_ecef(datum)


def _homogeneous(R, t):
    """(..., 4, 4) from (..., 3, 3) and (..., 3), with no host scalar
    written into a device tensor."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _enu_frame(llh):
    R = _enu_rotation(_deg2rad(llh[..., 0]), _deg2rad(llh[..., 1]))
    return R, ecef_point_from_llh(llh)


def enu_from_ecef_transform(datum, datum_is_llh: bool = True,
                            device=None) -> torch.Tensor:
    """4x4 transform taking ECEF points to the datum's local ENU frame
    (enuFromECEFTransformMatrix parity). A datum given as a list or array
    is taken at f64."""
    R, origin = _enu_frame(_datum_llh(datum, datum_is_llh, device))
    t = -torch.einsum("...ij,...j->...i", R, origin)
    return _homogeneous(R, t)


def ecef_from_enu_transform(datum, datum_is_llh: bool = True,
                            device=None) -> torch.Tensor:
    """Inverse of :func:`enu_from_ecef_transform`."""
    R, origin = _enu_frame(_datum_llh(datum, datum_is_llh, device))
    return _homogeneous(R.transpose(-1, -2), origin)


def enu_point_from_llh(point_llh, enu_datum, datum_is_llh: bool = True,
                       device=None):
    """LLH point -> local ENU of the datum (enuPointFromLLH parity). A
    datum given as a list or array is taken in the points' dtype and
    device."""
    point_llh = as_tensor(point_llh, device)
    ecef = ecef_point_from_llh(point_llh)
    T = enu_from_ecef_transform(_as_datum(enu_datum, point_llh),
                                datum_is_llh, device)
    return (
        torch.einsum("...ij,...j->...i", T[..., :3, :3], ecef)
        + T[..., :3, 3]
    )


def llh_point_from_enu(point_enu, enu_datum, datum_is_llh: bool = True,
                       device=None):
    """Local ENU point -> LLH (llhPointFromENU parity); a list datum as in
    :func:`enu_point_from_llh`."""
    point_enu = as_tensor(point_enu, device)
    T = ecef_from_enu_transform(_as_datum(enu_datum, point_enu),
                                datum_is_llh, device)
    ecef = (
        torch.einsum("...ij,...j->...i", T[..., :3, :3], point_enu)
        + T[..., :3, 3]
    )
    return llh_point_from_ecef(ecef)
