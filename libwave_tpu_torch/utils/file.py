"""Host-side filesystem helpers (port of ``libwave_tpu.utils.file``).

Capability parity with the reference's ``wave_utils`` file component
(wave_utils/include/wave/utils/file.hpp:28-47, src/file.cpp): ``remove_dir``,
``file_exists``, ``path_split``, ``paths_combine``. Pure host utilities; thin wrappers over the stdlib so behavior is portable.
"""

from __future__ import annotations

import os
import shutil
from typing import List

__all__ = ["remove_dir", "file_exists", "dir_exists", "path_split",
           "paths_combine"]


def remove_dir(path: str) -> bool:
    """Recursively delete a directory. Returns True on success.

    Parity: ``wave::remove_dir`` (file.hpp:28).
    """
    try:
        shutil.rmtree(path)
        return True
    except OSError:
        return False


def file_exists(path: str) -> bool:
    """True if ``path`` exists and is a regular file (file.hpp:33)."""
    return os.path.isfile(path)


def dir_exists(path: str) -> bool:
    """True if ``path`` exists and is a directory."""
    return os.path.isdir(path)


def path_split(path: str) -> List[str]:
    """Split a path into its non-empty components (file.hpp:40)."""
    return [p for p in path.split(os.sep) if p]


def paths_combine(path1: str, path2: str) -> str:
    """Join two paths, resolving any ``..``/``.`` segments in ``path2``
    against ``path1`` (parity: ``wave::paths_combine``, file.hpp:47, which
    walks ``..`` components explicitly)."""
    return os.path.normpath(os.path.join(path1, path2))
