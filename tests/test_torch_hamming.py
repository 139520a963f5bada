"""The port's Hamming functions (``libwave_tpu_torch.ops.hamming``) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_ops.py`` runs them.

On CPU tensors the wrappers return their plain PyTorch versions, which the
CUDA kernels are held to on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). The outputs are integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libwave_tpu.ops.hamming import hamming_distance_pallas
from libwave_tpu.ops.hamming import hamming_top2 as jax_top2
from libwave_tpu_torch import bench_frontend, interop
from libwave_tpu_torch.ops import hamming


def _bank(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)


def _cases():
    """(name, d1, d2, mask2) uint32 banks: ragged sizes, ties, masks."""
    rng = np.random.default_rng(0)
    out = []
    d2 = _bank(rng, 200, 8)
    d2[150:] = d2[:50]  # duplicate reference rows: ties at the best
    d1 = np.concatenate([d2[:40], _bank(rng, 90, 8)])
    mask = rng.random(200) < 0.7
    out.append(("ties+mask 130x200x8", d1, d2, mask))
    out.append(("all masked 130x200x8", d1, d2, np.zeros(200, bool)))
    one = np.zeros(200, bool)
    one[77] = True
    out.append(("one live column", d1, d2, one))
    out.append(("no mask 257x129x16", _bank(rng, 257, 16), _bank(rng, 129, 16),
                None))
    # few bits per word: many equal distances everywhere
    small = rng.integers(0, 4, (70, 4)).astype(np.uint32)
    out.append(("tie-heavy 70x300x4", small, np.tile(small, (5, 1))[:300],
                None))
    hi = _bank(rng, 33, 2) | np.uint32(1 << 31)  # bit 31 set in every word
    out.append(("bit 31 33x45x2", hi, _bank(rng, 45, 2), None))
    return out


CASES = _cases()


@pytest.mark.parametrize("name,d1,d2,mask", CASES, ids=[c[0] for c in CASES])
def test_top2_plain_equals_pallas(name, d1, d2, mask):
    m = None if mask is None else jnp.asarray(mask)
    ref = [np.asarray(x) for x in jax_top2(jnp.asarray(d1), jnp.asarray(d2), m)]
    tm = None if mask is None else torch.as_tensor(mask)
    before = hamming.hamming_top2.launches
    got = hamming.hamming_top2(interop.desc_from_numpy(d1, "cpu"),
                               interop.desc_from_numpy(d2, "cpu"), tm)
    assert hamming.hamming_top2.launches == before  # the CPU runs no kernel
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r)
    if mask is not None and not mask.any():
        assert (got[0] == hamming.BIG).all() and (got[1] == hamming.BIG).all()
        assert (got[2] == 0).all()


EDGES = bench_frontend.top2_edge_cases()


@pytest.mark.parametrize("name,d1,d2,mask", EDGES, ids=[c[0] for c in EDGES])
def test_top2_edge_cases_plain_equals_pallas(name, d1, d2, mask):
    """The cases the card holds the kernel's lane split and merge to
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``): ties across and
    within lanes, the only live column last, ragged N2, all masked."""
    m = None if mask is None else jnp.asarray(mask)
    ref = [np.asarray(x) for x in jax_top2(jnp.asarray(d1), jnp.asarray(d2), m)]
    got = hamming.hamming_top2(interop.desc_from_numpy(d1, "cpu"),
                               interop.desc_from_numpy(d2, "cpu"),
                               None if mask is None else torch.as_tensor(mask))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), r)
    if name.startswith("tie"):
        # the best is tied (second equals best) wherever column j is live
        assert (ref[1] == ref[0]).sum() >= len(d1) // 2


@pytest.mark.parametrize("name,d1,d2,mask", CASES, ids=[c[0] for c in CASES])
def test_table_plain_equals_pallas(name, d1, d2, mask):
    ref = np.asarray(hamming_distance_pallas(jnp.asarray(d1), jnp.asarray(d2)))
    before = hamming.hamming_distance.launches
    got = hamming.hamming_distance(interop.desc_from_numpy(d1, "cpu"),
                                   interop.desc_from_numpy(d2, "cpu"))
    assert hamming.hamming_distance.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_plain_versions_chunk_rows(monkeypatch):
    """Chunking over query rows (which bounds the XOR intermediate at the
    16,384^2 exact-matcher size) does not change the result."""
    rng = np.random.default_rng(3)
    d1, d2 = _bank(rng, 45, 4), _bank(rng, 61, 4)
    mask = torch.as_tensor(rng.random(61) < 0.5)
    t1, t2 = interop.desc_from_numpy(d1, "cpu"), interop.desc_from_numpy(d2, "cpu")
    whole = hamming.hamming_distance_reference(t1, t2)
    top = hamming.hamming_top2_reference(t1, t2, mask)
    monkeypatch.setattr(hamming, "_CHUNK_BYTES", 61 * 4 * 4 * 7)  # 7 rows
    assert len(hamming._row_chunks(45, 61, 4)) == 7
    assert torch.equal(hamming.hamming_distance_reference(t1, t2), whole)
    for a, b in zip(hamming.hamming_top2_reference(t1, t2, mask), top):
        assert torch.equal(a, b)


def test_descriptor_words_cross_bit_for_bit():
    words = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    t = interop.desc_from_numpy(words, "cpu")
    assert t.dtype == torch.int32
    assert t.tolist() == [[0, 1, -(2**31), -1]]
    np.testing.assert_array_equal(interop.desc_to_numpy(t), words)


def test_empty_reference_bank():
    d1 = torch.zeros((3, 4), dtype=torch.int32)
    best, second, idx = hamming.hamming_top2(d1, torch.zeros((0, 4), dtype=torch.int32))
    assert best.tolist() == [hamming.BIG] * 3 and second.tolist() == [hamming.BIG] * 3
    assert idx.tolist() == [0, 0, 0]


TABLE_EDGES = bench_frontend.table_edge_cases()
SMALL_TABLE_EDGES = [c for c in TABLE_EDGES if len(c[1]) * len(c[2]) <= 10**5]


@pytest.mark.parametrize("name,d1,d2", SMALL_TABLE_EDGES,
                         ids=[c[0] for c in SMALL_TABLE_EDGES])
def test_table_edge_cases_plain_equals_pallas(name, d1, d2):
    """The table cases the card holds the tensor-core kernel to
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``): every W, ragged N1
    and N2; the larger ones are held to the plain version alone."""
    ref = np.asarray(hamming_distance_pallas(jnp.asarray(d1), jnp.asarray(d2)))
    got = hamming.hamming_distance(interop.desc_from_numpy(d1, "cpu"),
                                   interop.desc_from_numpy(d2, "cpu"))
    np.testing.assert_array_equal(got.numpy(), ref)


_POPC8 = torch.tensor([bin(i).count("1") for i in range(256)],
                      dtype=torch.int32)


def _popc(x):
    """Bits set in each int32 word, summed over the last axis."""
    return _POPC8[x.contiguous().view(torch.uint8).long()].sum(-1)


def _and_popcount_table(d1, d2):
    """The tensor-core table kernel's arithmetic: k padded to whole 8-word
    (256-bit) steps with zero words, the row popcounts pa and pb, the
    AND-popcount products, and pa[i] + pb[j] - 2 * acc[i, j]."""
    w = d1.shape[1]
    kw = 8 * -(-w // 8)
    a = torch.nn.functional.pad(d1, (0, kw - w))
    b = torch.nn.functional.pad(d2, (0, kw - w))
    pa, pb = _popc(a), _popc(b)
    acc = torch.stack([_popc(torch.bitwise_and(row[None, :], b))
                       for row in a]) if len(a) else pa[:, None]
    return pa[:, None] + pb[None, :] - 2 * acc


@pytest.mark.parametrize("case", range(len(TABLE_EDGES) + 3))
def test_table_and_popcount_identity(case):
    """popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b), summed over the
    words with zero words padding k to 256 bits: what the card's table
    kernel computes equals the plain table exactly, on the shared edge
    cases (the 2,048-row bank cut to 300 rows) and on random banks with
    every bit pattern density."""
    if case < len(TABLE_EDGES):
        _, d1, d2 = TABLE_EDGES[case]
        d1, d2 = d1[:300], d2[:300]
    else:
        rng = np.random.default_rng(case)
        w = (3, 5, 12)[case - len(TABLE_EDGES)]  # widths off the 8-word grid
        dense = rng.integers(0, 2**32, (70, w), dtype=np.uint64)
        d1 = (dense & rng.integers(0, 2**32, (70, w), dtype=np.uint64)
              ).astype(np.uint32)
        d2 = np.concatenate([d1[:20], ~d1[20:40], dense[:30].astype(np.uint32)])
    t1, t2 = (interop.desc_from_numpy(x, "cpu") for x in (d1, d2))
    assert torch.equal(_and_popcount_table(t1, t2),
                       hamming.hamming_distance_reference(t1, t2))
