"""Typed config loading: dataclass params + YAML with validate-on-construct
(port of ``libwave_tpu.utils.config``).

The replacement for the reference's ``ConfigParser``
(wave_utils/include/wave/utils/config.hpp:108 ``addParam``/:151 ``load``):
every tunable component declares a frozen dataclass of parameters with
defaults, and this module fills such dataclasses from YAML or from a nested
mapping, with:

- nested dotted keys (``a.b.c``) as in the reference's yaml trees;
- numpy array fields from plain nested lists or the reference's
  ``{rows, cols, data}`` matrix layout (config.hpp:160-216 YAML->Eigen
  converters); arrays come out as numpy, and a caller moves them to its
  device;
- optional keys (the field keeps its default) and required keys
  (:class:`ConfigError`, as ConfigStatus::KeyError, config.hpp:27-36);
- a ``validate`` hook that raises on bad values (the reference's throwing
  Params constructors, e.g. fast_detector.hpp checkConfiguration).

PyYAML is optional: without it the module imports, :func:`from_dict`
works, and :func:`load_config` raises ``ConfigError("pyyaml
unavailable")``.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping, Type, TypeVar

import numpy as np

try:
    import yaml
except ImportError:
    yaml = None

T = TypeVar("T")


class ConfigError(Exception):
    """Raised on missing required keys, type mismatches, or failed
    validation (the reference's ConfigStatus error enum, config.hpp:27-36,
    as one exception type with a descriptive message)."""


def config_field(default=None, *, required: bool = False, **kw):
    """Declare a dataclass config field; ``required=True`` fields must
    appear in the YAML (ConfigParser's non-optional addParam)."""
    metadata = dict(kw.pop("metadata", {}) or {})
    metadata["required"] = required
    if isinstance(default, (list, dict, np.ndarray)):
        return dataclasses.field(
            default_factory=lambda: default, metadata=metadata, **kw
        )
    return dataclasses.field(default=default, metadata=metadata, **kw)


def _dig(tree: Mapping[str, Any], dotted: str):
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def _coerce(value: Any, typ: Any, key: str):
    if typ in (np.ndarray, "ndarray") or (
        isinstance(typ, str) and "ndarray" in typ
    ):
        return _to_array(value, key)
    origin = getattr(typ, "__origin__", None)
    if origin in (list, tuple):
        seq = list(value) if not isinstance(value, (list, tuple)) else value
        return origin(seq)
    if typ is bool or typ == "bool":
        if isinstance(value, bool):
            return value
        raise ConfigError(
            f"key '{key}': expected bool, got {type(value).__name__}")
    if typ is int or typ == "int":
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise ConfigError(f"key '{key}': expected int, got {value!r}")
        return int(value)
    if typ is float or typ == "float":
        if isinstance(value, bool) or not isinstance(
            value, (int, float, np.integer, np.floating)
        ):
            raise ConfigError(f"key '{key}': expected float, got {value!r}")
        return float(value)
    if typ is str or typ == "str":
        if not isinstance(value, str):
            raise ConfigError(f"key '{key}': expected str, got {value!r}")
        return value
    return value


def _to_array(value: Any, key: str) -> np.ndarray:
    """Plain nested lists or the reference's {rows, cols, data} layout
    (column-filled row-major as in config.hpp:160-216), as f64 numpy."""
    if isinstance(value, Mapping):
        try:
            rows, cols = int(value["rows"]), int(value["cols"])
            data = np.asarray(value["data"], dtype=np.float64)
        except (KeyError, TypeError, ValueError) as e:
            raise ConfigError(f"key '{key}': bad matrix spec: {e}") from e
        if data.size != rows * cols:
            raise ConfigError(
                f"key '{key}': matrix data has {data.size} entries, "
                f"expected rows*cols={rows * cols}"
            )
        return data.reshape(rows, cols)
    return np.asarray(value, dtype=np.float64)


def from_dict(cls: Type[T], tree: Mapping[str, Any], prefix: str = "") -> T:
    """Build dataclass ``cls`` from a nested mapping. Dotted ``prefix``
    selects a subtree. Unknown keys under the subtree are ignored (the
    reference only reads registered params)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    if prefix:
        try:
            tree = _dig(tree, prefix)
        except KeyError:
            raise ConfigError(f"missing config subtree '{prefix}'")
    kwargs = {}
    for f in dataclasses.fields(cls):
        required = bool(f.metadata.get("required", False))
        try:
            raw = _dig(tree, f.name)
        except KeyError:
            if required:
                raise ConfigError(f"missing required config key '{f.name}'")
            continue
        typ = _resolve_type(cls, f)
        if dataclasses.is_dataclass(f.type) or (
            isinstance(raw, Mapping) and dataclasses.is_dataclass(typ)
        ):
            kwargs[f.name] = from_dict(typ, raw)
        else:
            kwargs[f.name] = _coerce(raw, typ, f.name)
    return validate(cls(**kwargs))


def _resolve_type(cls, f: dataclasses.Field):
    t = f.type
    if isinstance(t, str):
        t = typing.get_type_hints(cls).get(f.name, t)
    return t


def load_config(cls: Type[T], path: str, prefix: str = "") -> T:
    """Load dataclass ``cls`` from a YAML file (ConfigParser::load
    parity)."""
    if yaml is None:
        raise ConfigError("pyyaml unavailable")
    try:
        with open(path, "r") as fh:
            tree = yaml.safe_load(fh) or {}
    except FileNotFoundError:
        raise ConfigError(f"config file not found: {path}")
    except yaml.YAMLError as e:
        raise ConfigError(f"malformed yaml {path}: {e}")
    return from_dict(cls, tree, prefix)


def validate(obj: T) -> T:
    """Run the object's ``validate()`` method if present; it raises
    :class:`ConfigError` (or ValueError) on invalid values. Returns obj."""
    check = getattr(obj, "validate", None)
    if callable(check):
        check()
    return obj
