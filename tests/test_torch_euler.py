"""Parity of libwave_tpu_torch.geometry.euler with libwave_tpu's: the wrap
helpers, euler2rot, euler2quat and quat2euler for sequences 321 and 123.
f64 inputs from a numpy seed; tolerance 1e-12 (the same formulas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.geometry import euler as jeu
from libwave_tpu_torch.geometry import euler as teu


def close(t, j, atol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.fixture
def angles(rng):
    return rng.uniform(-7.0, 7.0, size=(64,))


@pytest.mark.parametrize("name", ["wrap_to_pi", "wrap_to_two_pi",
                                  "wrap_to_180", "wrap_to_360", "deg2rad",
                                  "rad2deg"])
def test_wraps(name, angles):
    a = angles * (60.0 if "180" in name or "360" in name else 1.0)
    close(getattr(teu, name)(torch.as_tensor(a)),
          getattr(jeu, name)(jnp.asarray(a)), atol=1e-11)


@pytest.mark.parametrize("seq", [321, 123])
def test_euler_rot_quat_round_trip(seq, rng):
    e = rng.uniform(-1.4, 1.4, size=(32, 3))
    close(teu.euler2rot(torch.as_tensor(e), seq),
          jeu.euler2rot(jnp.asarray(e), seq))
    qt = teu.euler2quat(torch.as_tensor(e), seq)
    close(qt, jeu.euler2quat(jnp.asarray(e), seq))
    close(teu.quat2euler(qt, seq), jeu.quat2euler(jnp.asarray(qt.numpy()),
                                                  seq), atol=1e-10)
    # the round trip returns the angles (|theta| < pi/2)
    close(teu.quat2euler(qt, seq), e, atol=1e-10)


def test_f32_and_bad_sequence(rng):
    e = rng.uniform(-1.0, 1.0, size=(8, 3)).astype(np.float32)
    R = teu.euler2rot(torch.as_tensor(e), 321)
    assert R.dtype == torch.float32
    np.testing.assert_allclose(R.numpy(), np.asarray(
        jeu.euler2rot(jnp.asarray(e), 321)), atol=2e-7)
    for fn in (teu.euler2rot, teu.euler2quat, teu.quat2euler):
        with pytest.raises(ValueError, match="unsupported euler sequence"):
            fn(torch.zeros(4, dtype=torch.float64), 213)
