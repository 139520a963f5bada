"""The port's LSH matcher (``libwave_tpu_torch.vision.flann`` and the
``method="lsh"`` branch of ``vision.matcher.match_descriptors``) against the
JAX package's, from the same numpy banks.

Tolerance: exact. The bit samples are the same numpy draw, keys are
integer sums, the sort is stable in both, ties in the candidate argmin go to
the first position in both, so the index, the matches and the candidate
counts are equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.vision import flann as jfl
from libwave_tpu.vision import matcher as jm
from libwave_tpu_torch import interop
from libwave_tpu_torch.utils.config import ConfigError, validate
from libwave_tpu_torch.vision import flann as tfl
from libwave_tpu_torch.vision import matcher as tm


def _planted(rng, n_train, n_query, words, flips):
    """``bench.py``'s planted banks: queries are train rows with ``flips``
    random bits flipped."""
    d2 = rng.integers(0, 2**32, (n_train, words), dtype=np.uint32)
    src = rng.integers(0, n_train, n_query)
    d1 = d2[src].copy()
    for i in range(n_query):
        for b in rng.integers(0, words * 32, flips):
            d1[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d1, d2, src


def _d(a):
    return interop.desc_from_numpy(a, "cpu")


CASES = {
    "16 words, 20 flips": dict(n_train=2048, n_query=512, words=16, flips=20,
                               params=jfl.FLANNParams()),
    "8 words (ORB), capacity 32": dict(
        n_train=1500, n_query=300, words=8, flips=6,
        params=jfl.FLANNParams(bucket_capacity=32)),
    "6 tables, 10 key bits, masked": dict(
        n_train=700, n_query=200, words=16, flips=12,
        params=jfl.FLANNParams(num_tables=6, key_bits=10, ratio_threshold=0.7),
        mask=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_and_matches_bit_for_bit(case):
    c = CASES[case]
    rng = np.random.default_rng(7)
    d1, d2, src = _planted(rng, c["n_train"], c["n_query"], c["words"],
                           c["flips"])
    m1 = np.ones(len(d1), bool)
    m2 = np.ones(len(d2), bool)
    if c.get("mask"):
        m1[::5] = False
        m2[: len(d2) // 3] = False
    jp = c["params"]
    tp = interop.params_from_jax(jp)
    ij = jfl.build_lsh_index(jnp.asarray(d2), jnp.asarray(m2), jp)
    it = tfl.build_lsh_index(_d(d2), torch.from_numpy(m2), tp)
    np.testing.assert_array_equal(it.sorted_ids.numpy(),
                                  np.asarray(ij.sorted_ids))
    np.testing.assert_array_equal(it.offsets.numpy(), np.asarray(ij.offsets))
    assert it.sorted_ids.dtype == it.offsets.dtype == torch.int32

    idx_j, val_j, diag_j = jfl.lsh_match(jnp.asarray(d1), jnp.asarray(m1),
                                         ij, jp)
    idx_t, val_t, diag_t = tfl.lsh_match(_d(d1), torch.from_numpy(m1), it, tp)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(diag_t["num_candidates"].numpy(),
                                  np.asarray(diag_j["num_candidates"]))
    assert int(diag_t["num_good_matches"]) == int(diag_j["num_good_matches"])
    recall = ((idx_t.numpy() == src) & val_t.numpy())[m1].mean()
    print(f"{case}: recall of the planted rows {recall:.4f}, mean candidates "
          f"{diag_t['num_candidates'].float().mean():.1f}")
    assert recall > 0.5
    if c.get("mask"):
        assert (idx_t.numpy()[val_t.numpy()] >= len(d2) // 3).all()


def test_bit_samples_and_keys_with_bit_31():
    """The numpy draw is the reference's; words with bit 31 set (negative
    int32) hash as their uint32 pattern."""
    for args in ((4, 12, 512, 5489), (6, 10, 256, 3)):
        np.testing.assert_array_equal(tfl._bit_samples(*args),
                                      jfl._bit_samples(*args))
    d = np.array([[0xFFFFFFFF] * 8, [0x80000000] * 8, [1] * 8, [0] * 8],
                 np.uint32)
    jp = jfl.FLANNParams(key_bits=20)
    bits = jnp.asarray(jfl._bit_samples(4, 20, 256, jp.seed))
    np.testing.assert_array_equal(
        tfl._hash_keys(_d(d), interop.params_from_jax(jp)).numpy(),
        np.asarray(jfl._hash_keys(jnp.asarray(d), bits)))


@pytest.mark.parametrize("ransac", [False, True])
def test_match_descriptors_lsh_branch(ransac):
    """``MatcherParams(method="lsh")`` with the matcher-level ratio, and a
    user ``FLANNParams`` that overrides it. Without RANSAC the matches equal
    the JAX package's; with it the samples differ (generators), so the port
    is held to the planted correspondences: its inliers are a subset of the
    ratio-test survivors, every one a planted pair."""
    rng = np.random.default_rng(0)
    N, W = 512, 8
    d2 = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    perm = rng.permutation(N)
    d1 = d2[perm].copy()
    for i in range(N):
        for bb in rng.integers(0, W * 32, 4):
            d1[i, bb // 32] ^= np.uint32(1) << np.uint32(bb % 32)
    xy = rng.uniform(0, 400, (N, 2)).astype(np.float32)
    m = np.ones(N, bool)
    for jp in (jm.MatcherParams(method="lsh", ratio_threshold=0.7,
                                auto_remove_outliers=ransac),
               jm.MatcherParams(method="lsh", auto_remove_outliers=ransac,
                                flann=jfl.FLANNParams(ratio_threshold=0.9,
                                                      num_tables=3))):
        tp = interop.params_from_jax(jp)
        ij, vj, dj = jm.match_descriptors(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(xy[perm]),
            jnp.asarray(xy), jnp.asarray(m), jnp.asarray(m),
            jax.random.key(0), jp)
        it, vt, dt = tm.match_descriptors(
            _d(d1), _d(d2), torch.from_numpy(xy[perm]), torch.from_numpy(xy),
            torch.from_numpy(m), torch.from_numpy(m),
            torch.Generator().manual_seed(0), tp)
        np.testing.assert_array_equal(dt["num_candidates"].numpy(),
                                      np.asarray(dj["num_candidates"]))
        assert int(dt["num_filtered_matches"]) == int(
            dj["num_filtered_matches"])
        if not ransac:
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        got = it.numpy()[vt.numpy()]
        assert len(got) > 0.5 * N
        assert (got == perm[vt.numpy()]).all()


def test_batched_banks_match_each_alone():
    rng = np.random.default_rng(3)
    banks = [_planted(rng, 600, 200, 16, 10) for _ in range(2)]
    p = tm.MatcherParams(method="lsh", auto_remove_outliers=False)
    xy1 = torch.zeros((2, 200, 2))
    xy2 = torch.zeros((2, 600, 2))
    m1 = torch.ones((2, 200), dtype=torch.bool)
    m2 = torch.ones((2, 600), dtype=torch.bool)
    ib, vb, db = tm.match_descriptors(
        torch.stack([_d(b[0]) for b in banks]),
        torch.stack([_d(b[1]) for b in banks]), xy1, xy2, m1, m2, None, p)
    for b, (d1, d2, _) in enumerate(banks):
        i1, v1, d1g = tm.match_descriptors(_d(d1), _d(d2), xy1[b], xy2[b],
                                           m1[b], m2[b], None, p)
        assert torch.equal(ib[b], i1) and torch.equal(vb[b], v1)
        assert torch.equal(db["num_candidates"][b], d1g["num_candidates"])


def test_params_defaults_and_validation():
    assert dataclasses.asdict(jfl.FLANNParams()) == dataclasses.asdict(
        tfl.FLANNParams())
    for bad in (tfl.FLANNParams(num_tables=0), tfl.FLANNParams(key_bits=0),
                tfl.FLANNParams(bucket_capacity=1),
                tfl.FLANNParams(ratio_threshold=1.5)):
        with pytest.raises(ConfigError):
            validate(bad)
