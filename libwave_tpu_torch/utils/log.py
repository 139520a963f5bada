"""Logging with file:line provenance (port of ``libwave_tpu.utils.log``).

Thin wrappers over :mod:`logging` that record the caller's file:line,
parity with the reference's LOG_ERROR/LOG_INFO printf macros. The logger
("libwave_tpu_torch") gets its stderr handler on first use, not at import.
"""

from __future__ import annotations

import logging
import sys


def _logger() -> logging.Logger:
    log = logging.getLogger("libwave_tpu_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(levelname)s] [%(filename)s:%(lineno)d] %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


def log_info(msg: str, *args) -> None:
    _logger().info(msg, *args, stacklevel=2)


def log_warn(msg: str, *args) -> None:
    _logger().warning(msg, *args, stacklevel=2)


def log_error(msg: str, *args) -> None:
    _logger().error(msg, *args, stacklevel=2)
