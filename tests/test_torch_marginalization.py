"""The port's host-side Schur marginalization
(``libwave_tpu_torch.optim.marginalization``, a copy of the JAX package's
numpy module) against the JAX package's on the same numpy inputs: SPD
information matrices, an indefinite keep block (the PSD clip), a
barely-constrained out direction (the ridge), an information-free one (the
least-squares fallback) and keep-all. Both run the same f64 numpy
operations in the same order, so the outputs are equal bit for bit."""

import numpy as np
import pytest

from libwave_tpu.optim import marginalization as jm
from libwave_tpu_torch.optim import marginalization as tm


def _spd(rng, n, scale=1.0):
    A = rng.standard_normal((n, n))
    return scale * (A @ A.T) + 0.5 * np.eye(n)


def _cases():
    rng = np.random.default_rng(11)
    out = []
    for n, k in ((12, 5), (30, 15), (8, 1)):
        out.append((f"spd n={n} keep={k}", _spd(rng, n), rng.standard_normal(n),
                    k))
    H = _spd(rng, 8)
    H[7, 7] -= 500.0  # the complement gets a negative eigenvalue
    out.append(("indefinite keep block", H, rng.standard_normal(8), 4))
    H = _spd(rng, 10)
    H[0, :] *= 1e-12
    H[:, 0] *= 1e-12  # a barely-constrained out direction
    out.append(("weak out direction", H, rng.standard_normal(10), 4))
    H = _spd(rng, 9)
    H[:3, :] = 0.0
    H[:, :3] = 0.0  # information-free out directions: H_oo singular
    out.append(("information-free out directions", H, rng.standard_normal(9),
                5))
    # a chained prior: anchor-sized information beside weak directions
    H = _spd(rng, 15)
    H[:6, :6] += 1e10 * np.eye(6)
    out.append(("anchor beside weak directions", H, rng.standard_normal(15),
                9))
    out.append(("keep all", _spd(rng, 6), rng.standard_normal(6), 6))
    return out


CASES = _cases()


@pytest.mark.parametrize("name,H,b,k", CASES, ids=[c[0] for c in CASES])
def test_schur_marginalize_equals_reference(name, H, b, k):
    Lam_t, bm_t = tm.schur_marginalize(H, b, keep_dim=k)
    Lam_j, bm_j = jm.schur_marginalize(H, b, keep_dim=k)
    assert Lam_t.shape == (k, k) and bm_t.shape == (k,)
    np.testing.assert_array_equal(Lam_t, Lam_j)
    np.testing.assert_array_equal(bm_t, bm_j)
    assert np.linalg.eigvalsh(Lam_t).min() >= -1e-9 * max(
        1.0, np.abs(Lam_t).max())


@pytest.mark.parametrize("name,H,b,k", CASES, ids=[c[0] for c in CASES])
def test_psd_project_equals_reference(name, H, b, k):
    sym = 0.5 * (H[-k:, -k:] + H[-k:, -k:].T)
    sym[0, 0] -= 3.0 * np.abs(sym).max()  # negative curvature to clip
    got = tm.psd_project(sym, b[-k:])
    ref = jm.psd_project(sym, b[-k:])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
