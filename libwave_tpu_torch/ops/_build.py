"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
sources under ``libwave_tpu_torch/csrc`` into ``libwave_tpu_torch/_build``
(listed in ``.gitignore``), with a plain C interface that ``ctypes`` loads.
The output name carries a hash of the sources and flags, so an edited
source rebuilds and concurrent builds never see a half-written file
(each compiles to a private temporary name and renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class NvccError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise NvccError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, sources: list[str]) -> tuple[Path, str]:
    """Compile ``sources`` (file names under ``csrc``) into
    ``_build/lib<name>-<hash>.so``. Returns the library's path and the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills);
    an up-to-date library is reused and its saved output returned."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    stem = f"lib{name}-{digest.hexdigest()[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NvccError(f"nvcc failed ({proc.returncode}):\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)
    return lib, out


def load(name: str, sources: list[str]) -> tuple[ctypes.CDLL, str]:
    """:func:`build`, then load the library with ``ctypes``."""
    lib, out = build(name, sources)
    return ctypes.CDLL(str(lib)), out
