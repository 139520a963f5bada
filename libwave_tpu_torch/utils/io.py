"""CSV / text matrix I/O (port of ``libwave_tpu.utils.io``).

Parity with the reference's data helpers (wave_utils/include/wave/utils/
data.hpp:27-62 ``csvrows``/``csvcols``/``csv2mat``/``mat2csv``/
``matrixFromStream``). Host-side numpy; arrays cross into torch at the caller.
"""

from __future__ import annotations

import io as _io

import numpy as np


def csvrows(path: str, header: bool = False) -> int:
    with open(path, "r") as fh:
        n = sum(1 for line in fh if line.strip())
    return n - (1 if header else 0)


def csvcols(path: str) -> int:
    with open(path, "r") as fh:
        first = fh.readline()
    return len([c for c in first.strip().split(",") if c != ""])


def csv2mat(path: str, header: bool = False) -> np.ndarray:
    """Load a CSV file into a float64 matrix."""
    return np.loadtxt(path, delimiter=",", skiprows=1 if header else 0, ndmin=2)


def mat2csv(path: str, mat: np.ndarray) -> None:
    """Write a matrix as CSV (no header), matching the reference layout."""
    np.savetxt(path, np.asarray(mat), delimiter=",")


def matrix_from_string(text: str) -> np.ndarray:
    """Parse a whitespace/newline-delimited matrix from a string
    (matrixFromStream parity, data.hpp:62)."""
    return np.loadtxt(_io.StringIO(text), ndmin=2)
