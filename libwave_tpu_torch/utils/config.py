"""Parameter validation (port of ``libwave_tpu.utils.config``'s error type
and ``validate``).

Every tunable component declares a frozen dataclass of parameters whose
``validate`` method raises :class:`ConfigError` on bad values, as the
reference's throwing Params constructors do. YAML loading is not ported yet
(see ROADMAP.md).
"""

from __future__ import annotations

from typing import TypeVar

T = TypeVar("T")


class ConfigError(Exception):
    """Raised on missing required keys, type mismatches, or failed
    validation."""


def validate(obj: T) -> T:
    """Run the object's ``validate()`` method if present; it raises
    :class:`ConfigError` (or ValueError) on invalid values. Returns obj."""
    check = getattr(obj, "validate", None)
    if callable(check):
        check()
    return obj
