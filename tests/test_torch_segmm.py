"""The port's G/A build (libwave_tpu_torch.ops.segmm) against the Pallas
kernel of libwave_tpu.ops.segmm, run in interpret mode on the CPU.

Both follow the reference kernel's f32 contract: G is summed (in the input
dtype here) and rounded to f32, A is formed in f32 from f32 G and Hinv.
Tolerances:
- G: 1e-12 * max|G| at f64 (both round the same f64 sums to f32) and
  1e-6 * max|G| at f32 (the same f32 terms, summed in another order);
- A: 1e-6 * max|A| at both dtypes. XLA forms the Pallas kernel's f32
  products and sums in an order (and with contractions) PyTorch does not
  reproduce, so A differs by f32 rounding even when G is identical:
  measured one f32 ulp, about 6e-8 * max|A|.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
compares it with the plain version there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.ops.segmm import dense_g_a_onehot
from libwave_tpu_torch.ops import segmm


def _inputs(rng, N, P, M, dtype, lo=0, hi=None, dup=False, pad_rows=()):
    hi = M if hi is None else hi
    W = rng.standard_normal((18, N, P)).astype(dtype)
    ids = rng.integers(lo, hi, (N, P)).astype(np.int32)
    W[:, :, -3:] = 0.0  # zero-weight padding slots (the ELL contract)
    ids[:, -3:] = 0
    if dup:
        ids[:, : P // 3] = ids[:, :1]
    for n in pad_rows:
        ids[n] = -1  # the pose-padding id
    hinv = rng.standard_normal((6, M)).astype(dtype)
    return W, ids, hinv


CASES = {
    # name: (N, P, M, lo, hi, dup, pad_rows)
    "plain": (7, 40, 61, 0, None, False, ()),
    "duplicates": (5, 37, 300, 0, 300, True, ()),
    "padding_rows": (6, 37, 300, 0, 300, False, (1, 4)),
    "chunk_offset": (4, 64, 300, -250, 400, True, ()),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_g_a_matches_pallas(case, dtype, rng):
    N, P, M, lo, hi, dup, pad_rows = CASES[case]
    W, ids, hinv = _inputs(rng, N, P, M, dtype, lo, hi, dup, pad_rows)
    gj, aj = dense_g_a_onehot(jnp.asarray(W), jnp.asarray(ids),
                              jnp.asarray(hinv))
    gt, at = segmm.dense_g_a(torch.as_tensor(W), torch.as_tensor(ids),
                             torch.as_tensor(hinv))
    assert gt.shape == at.shape == (N, 18, M)
    assert gt.dtype == at.dtype == torch.from_numpy(W).dtype
    gj, aj = np.asarray(gj), np.asarray(aj)
    g_tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=g_tol * np.abs(gj).max())
    np.testing.assert_allclose(at.numpy(), aj, rtol=0,
                               atol=1e-6 * np.abs(aj).max())
    for n in pad_rows:
        assert not gt[n].any() and not at[n].any()


def test_out_of_range_ids_contribute_nothing(rng):
    """A chunked caller's view: ids shifted by c0, only [0, M) counts."""
    W, ids, hinv = _inputs(rng, 3, 20, 50, np.float64, -60, 110)
    G, _ = segmm.dense_g_a_reference(torch.as_tensor(W), torch.as_tensor(ids),
                                     torch.as_tensor(hinv))
    ref = np.zeros((3, 18, 50))
    for n in range(3):
        for s in range(20):
            if 0 <= ids[n, s] < 50:
                ref[n, :, ids[n, s]] += W[:, n, s]
    np.testing.assert_allclose(G.numpy(), ref.astype(np.float32), rtol=0,
                               atol=0)


def test_cpu_path_counts_no_launch(rng):
    W, ids, hinv = _inputs(rng, 2, 8, 10, np.float32)
    before = segmm.dense_g_a.launches
    segmm.dense_g_a(torch.as_tensor(W), torch.as_tensor(ids),
                    torch.as_tensor(hinv))
    assert segmm.dense_g_a.launches == before


def test_non_cpu_non_cuda_tensor_raises():
    W = torch.zeros((18, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segmm.dense_g_a(W, torch.zeros((2, 4), dtype=torch.int32,
                                       device="meta"),
                        torch.zeros((6, 5), device="meta"))
