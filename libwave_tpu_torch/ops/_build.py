"""Build, load and launch the package's CUDA libraries.

The module that wraps a library declares it once (:func:`library`: name,
sources under ``libwave_tpu_torch/csrc``, entry points' C signatures).
:func:`load` compiles it at first use, never at import, with ``nvcc`` for
``sm_90a`` (Hopper) into ``libwave_tpu_torch/_build`` (listed in
``.gitignore``) and loads it with ``ctypes``. The output name carries a
hash of the sources and flags, so an edited source rebuilds and concurrent
builds never see a half-written file (each compiles to a private temporary
name and renames it into place). :func:`launch` calls an entry point.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


def _compile(name: str, sources: tuple[str, ...]) -> tuple[Path, str]:
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


@dataclasses.dataclass(frozen=True, eq=False)
class Library:
    """A CUDA library of the package: its ``name``, its ``sources`` under
    ``csrc`` and its entry points' signatures: by entry point, the
    ``ctypes`` attributes that give its argument and result types."""

    name: str
    sources: tuple[str, ...]
    signatures: dict


# every library of the package by name, as the modules that wrap them
# declare them (:func:`library`)
LIBRARIES: dict[str, Library] = {}


def library(name: str, sources: tuple[str, ...],
            signatures: dict) -> Library:
    """Declare the library ``name``; nothing is built until :func:`load`."""
    lib = LIBRARIES[name] = Library(name, tuple(sources), signatures)
    return lib


@functools.cache
def load(lib: Library) -> tuple[ctypes.CDLL, str]:
    """Build (or reuse) and load ``lib``, its entry points' types set;
    returns it with the compiler's ``-Xptxas -v`` report."""
    path, log = _compile(lib.name, lib.sources)
    cdll = ctypes.CDLL(str(path))
    for fn_name, types in lib.signatures.items():
        for attr, value in types.items():
            setattr(getattr(cdll, fn_name), attr, value)
    return cdll, log


def build(lib: Library) -> str:
    """Build (or reuse) and load ``lib``; returns the compiler's report."""
    return load(lib)[1]


def launch(lib: Library, fn_name: str, *args):
    """Call ``lib``'s entry point ``fn_name`` on the current stream of the
    first argument's device: tensors go as their data pointers, the stream
    last; raise if the launch failed."""
    cdll, _ = load(lib)
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(cdll, fn_name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
