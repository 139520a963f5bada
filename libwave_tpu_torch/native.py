"""Host-side native helpers: exact kNN and voxel oracles, PCD and CSV
readers.

The port's copy of ``libwave_tpu.native``: the same
``native/wave_native.cpp``, compiled with ``g++`` at first use into
``libwave_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the source, so an edited source rebuilds and concurrent
builds never load a half-written file, and bound through ``ctypes``. Every
entry point has the same numpy fallback as the JAX package's, taken when
there is no compiler; :func:`route` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "wave_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> Path | None:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libwave_native-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"libwave_native-{digest}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def load():
    """Load (building if needed) the native library, or None if
    unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _build_failed = True
            return None
        lib.wave_knn_exact.restype = ctypes.c_int
        lib.wave_knn_exact.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.wave_voxel_downsample.restype = ctypes.c_int64
        lib.wave_voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        lib.wave_load_pcd.restype = ctypes.c_int64
        lib.wave_load_pcd.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.wave_load_csv.restype = ctypes.c_int64
        lib.wave_load_csv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def route() -> str:
    """``"native"`` when the compiled library serves the entry points,
    ``"numpy"`` when their fallbacks do."""
    return "native" if available() else "numpy"


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_exact(query: np.ndarray, target: np.ndarray, k: int):
    """Exact kNN oracle. Returns (idx (N, k) int32, dist2 (N, k) float32)."""
    query = np.ascontiguousarray(query, dtype=np.float32)
    target = np.ascontiguousarray(target, dtype=np.float32)
    n, m = len(query), len(target)
    lib = load()
    if lib is not None:
        idx = np.empty((n, k), dtype=np.int32)
        d2 = np.empty((n, k), dtype=np.float32)
        ret = lib.wave_knn_exact(
            _fptr(query), n, _fptr(target), m, k,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _fptr(d2),
        )
        if ret == 0:
            return idx, d2
    D = ((query[:, None, :] - target[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(D, axis=1)[:, :k].astype(np.int32)
    d2 = np.take_along_axis(D, idx, axis=1).astype(np.float32)
    return idx, d2


def voxel_downsample_exact(points: np.ndarray, leaf: float) -> np.ndarray:
    """Collision-free voxel-mean downsample (pcl::VoxelGrid oracle)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = len(points)
    lib = load()
    if lib is not None:
        out = np.empty((n, 3), dtype=np.float32)
        m = lib.wave_voxel_downsample(_fptr(points), n, leaf, _fptr(out))
        if m >= 0:
            return out[:m]
    keys = np.floor(points / leaf).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    m = inv.max() + 1
    sums = np.zeros((m, 3), dtype=np.float64)
    cnts = np.zeros(m, dtype=np.int64)
    np.add.at(sums, inv, points)
    np.add.at(cnts, inv, 1)
    return (sums / cnts[:, None]).astype(np.float32)


def load_pcd(path: str) -> np.ndarray:
    """Read a .pcd file's x/y/z fields -> (N, 3) float32."""
    lib = load()
    if lib is not None:
        n = lib.wave_load_pcd(path.encode(), None, 0)
        if n >= 0:
            out = np.empty((n, 3), dtype=np.float32)
            m = lib.wave_load_pcd(path.encode(), _fptr(out), n)
            if m == n:
                return out
        if n < 0 and n != -1:
            raise ValueError(f"malformed pcd file: {path} (code {n})")
        if n == -1:
            raise FileNotFoundError(path)
    # numpy fallback (ascii only)
    with open(path, "rb") as fh:
        header = {}
        fields = []
        while True:
            line = fh.readline().decode("latin1")
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            if line.startswith("POINTS"):
                header["points"] = int(line.split()[1])
            if line.startswith("DATA"):
                header["binary"] = "binary" in line
                break
        if header.get("binary"):
            raise NotImplementedError("binary pcd needs the native reader")
        data = np.loadtxt(fh)
    sel = [fields.index(c) for c in ("x", "y", "z")]
    return data[:, sel].astype(np.float32)


def load_csv(path: str) -> np.ndarray:
    """Read a numeric CSV (comments/headers skipped) -> (rows, cols) f64."""
    lib = load()
    if lib is not None:
        cols = ctypes.c_int32(0)
        rows = lib.wave_load_csv(path.encode(), None, 0, ctypes.byref(cols))
        if rows >= 0 and cols.value > 0:
            out = np.empty((rows, cols.value), dtype=np.float64)
            filled = lib.wave_load_csv(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                out.size, ctypes.byref(cols),
            )
            if filled == rows:
                return out
        if rows == -1:
            raise FileNotFoundError(path)
    return np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
