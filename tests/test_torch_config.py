"""Parity of libwave_tpu_torch.utils.config with libwave_tpu's: every case
of tests/test_utils.py's ``TestConfig`` on the port, and each against the
JAX package on the same input: ``from_dict`` and ``load_config`` build
equal dataclasses (arrays equal exactly), and every ``ConfigError`` fires
on the same input with the same message. Without PyYAML the port's
``load_config`` raises ``ConfigError("pyyaml unavailable")`` and
``from_dict`` still works.
"""

import dataclasses

import numpy as np
import pytest

from libwave_tpu.utils import config as jc
from libwave_tpu_torch.utils import config as tc
from libwave_tpu_torch.vision.flann_float import FloatIndexParams


@dataclasses.dataclass(frozen=True)
class DemoParams:
    bool_val: bool = False
    int_val: int = 0
    float_val: float = 0.0
    string_val: str = ""
    vector: np.ndarray = tc.config_field(None)
    matrix: np.ndarray = tc.config_field(None)
    required_key: int = tc.config_field(7, required=False)


@dataclasses.dataclass(frozen=True)
class ValidatedParams:
    threshold: int = 10

    def validate(self):
        if self.threshold < 0:
            raise tc.ConfigError("threshold must be >= 0")


@dataclasses.dataclass(frozen=True)
class Inner:
    gain: float = 1.0
    K: np.ndarray = tc.config_field(None)


@dataclasses.dataclass(frozen=True)
class Outer:
    name: str = "x"
    inner: Inner = dataclasses.field(default_factory=Inner)
    steps: int = tc.config_field(0, required=True)


YAML_FIXTURE = """
config:
  bool_val: true
  int_val: 3
  float_val: 2.5
  string_val: hello
  vector: [1.0, 2.0, 3.0]
  matrix:
    rows: 2
    cols: 2
    data: [1.0, 2.0, 3.0, 4.0]
"""


def same(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            same(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


def both_raise(fn_t, fn_j, match=None):
    with pytest.raises(tc.ConfigError, match=match) as et:
        fn_t()
    # a dataclass's own validate() raises the port's error in both
    with pytest.raises((jc.ConfigError, tc.ConfigError)) as ej:
        fn_j()
    assert str(et.value) == str(ej.value)


def test_load(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(YAML_FIXTURE)
    cfg = tc.load_config(DemoParams, str(p), prefix="config")
    same(cfg, jc.load_config(DemoParams, str(p), prefix="config"))
    assert cfg.bool_val is True and cfg.int_val == 3
    assert cfg.float_val == 2.5 and cfg.string_val == "hello"
    np.testing.assert_allclose(cfg.vector, [1.0, 2.0, 3.0])
    np.testing.assert_allclose(cfg.matrix, [[1.0, 2.0], [3.0, 4.0]])
    assert cfg.required_key == 7  # optional, default kept


def test_missing_file():
    both_raise(lambda: tc.load_config(DemoParams, "/nonexistent/path.yaml"),
               lambda: jc.load_config(DemoParams, "/nonexistent/path.yaml"))


def test_malformed_yaml(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("a: [1, 2\n")
    with pytest.raises(tc.ConfigError, match="malformed yaml"):
        tc.load_config(DemoParams, str(p))
    with pytest.raises(jc.ConfigError, match="malformed yaml"):
        jc.load_config(DemoParams, str(p))


def test_missing_required():
    @dataclasses.dataclass
    class Req:
        must: int = tc.config_field(0, required=True)

    both_raise(lambda: tc.from_dict(Req, {}), lambda: jc.from_dict(Req, {}),
               match="must")


@pytest.mark.parametrize("tree", [
    {"int_val": "nope"},
    {"int_val": True},
    {"bool_val": 1},
    {"float_val": "1.5"},
    {"string_val": 3},
    {"matrix": {"rows": 2, "cols": 2, "data": [1.0]}},
    {"matrix": {"rows": 2, "data": [1.0]}},
])
def test_type_mismatch_and_bad_matrix(tree):
    both_raise(lambda: tc.from_dict(DemoParams, tree),
               lambda: jc.from_dict(DemoParams, tree))


def test_validate_on_construct():
    both_raise(lambda: tc.from_dict(ValidatedParams, {"threshold": -1}),
               lambda: jc.from_dict(ValidatedParams, {"threshold": -1}))
    assert tc.from_dict(ValidatedParams, {"threshold": 5}).threshold == 5


def test_dotted_keys_and_missing_subtree():
    @dataclasses.dataclass
    class Nested:
        value: float = 0.0

    tree = {"a": {"b": {"value": 1.5}}}
    cfg = tc.from_dict(Nested, tree, prefix="a.b")
    same(cfg, jc.from_dict(Nested, tree, prefix="a.b"))
    assert cfg.value == 1.5
    both_raise(lambda: tc.from_dict(Nested, tree, prefix="a.c"),
               lambda: jc.from_dict(Nested, tree, prefix="a.c"))


def test_nested_dataclass_with_matrix():
    """chip_smoke.py's leaves phase's case: a nested dataclass holding a
    {rows, cols, data} matrix, and a component's parameters."""
    tree = {"name": "cam", "steps": 4,
            "inner": {"gain": 2, "K": {"rows": 2, "cols": 3,
                                       "data": [1, 2, 3, 4, 5, 6]}}}
    cfg = tc.from_dict(Outer, tree)
    same(cfg, jc.from_dict(Outer, tree))
    assert cfg.inner.gain == 2.0 and cfg.inner.K.shape == (2, 3)
    both_raise(lambda: tc.from_dict(Outer, {"name": "cam"}),
               lambda: jc.from_dict(Outer, {"name": "cam"}))
    p = tc.from_dict(FloatIndexParams, {"method": "kmeans", "key_bits": 9})
    assert p == FloatIndexParams(method="kmeans", key_bits=9)
    with pytest.raises(tc.ConfigError):
        tc.from_dict(FloatIndexParams, {"method": "kd"})


def test_no_pyyaml(monkeypatch, tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(YAML_FIXTURE)
    monkeypatch.setattr(tc, "yaml", None)
    with pytest.raises(tc.ConfigError, match="^pyyaml unavailable$"):
        tc.load_config(DemoParams, str(p), prefix="config")
    assert tc.from_dict(DemoParams, {"int_val": 2}).int_val == 2


def test_validate_passthrough():
    obj = ValidatedParams(3)
    assert tc.validate(obj) is obj
    with pytest.raises(tc.ConfigError):
        tc.validate(ValidatedParams(-2))
