"""Approximate binary-descriptor matching by multi-table LSH (port of
``libwave_tpu.vision.flann``, the FLANNMatcher analog,
flann_matcher.hpp:39-51).

Each of ``num_tables`` tables hashes ``key_bits`` sampled descriptor bits
(positions drawn by numpy from the reference's seed) into an integer key.
The train bank is bucketed once: ids stably sorted by key per table, and a
``(tables, 2^key_bits + 2)`` table of bucket start offsets (masked train
rows hash to an overflow bucket past every real key). Each query gathers a
fixed ``bucket_capacity`` slice of candidates per table and computes Hamming
distances only against those; the knn ratio test masks every entry of the
best id before it takes the second best, so a row reached through several
tables does not ratio-test against itself.

Descriptor words are the port's int32 (uint32 bit patterns). A bit is read
as ``(word >> k) & 1``, which the arithmetic shift leaves right; the
candidate popcount is ``ops.hamming.popcount_words``. The reference computes
the candidate XOR and popcount outside any kernel, and so does the port: the
whole matcher is plain PyTorch, and its index and matches equal the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from libwave_tpu_torch.ops.hamming import BIG, popcount_words
from libwave_tpu_torch.utils.config import ConfigError

__all__ = ["FLANNParams", "build_lsh_index", "lsh_match", "LSHIndex"]


@dataclasses.dataclass(frozen=True)
class FLANNParams:
    """flann_matcher.hpp:39-51 parameter parity (LSH branch: table_number,
    key_size; ratio test as in the shared DescriptorMatcher pipeline)."""

    num_tables: int = 4
    key_bits: int = 12
    bucket_capacity: int = 64
    ratio_threshold: float = 0.8
    seed: int = 5489  # reference FLANN's default RNG seed

    def validate(self):
        if self.num_tables <= 0:
            raise ConfigError("num_tables must be positive")
        if not 1 <= self.key_bits <= 20:
            raise ConfigError("key_bits must be in [1, 20]")
        if self.bucket_capacity <= 1:
            raise ConfigError("bucket_capacity must be > 1")
        if not 0 < self.ratio_threshold <= 1:
            raise ConfigError("ratio_threshold must be in (0, 1]")


@functools.lru_cache(maxsize=16)
def _bit_samples(num_tables: int, key_bits: int, total_bits: int, seed: int):
    """(L, key_bits) int32 bit positions, the reference's numpy draw."""
    rng = np.random.default_rng(seed)
    idx = np.stack([
        rng.choice(total_bits, size=key_bits, replace=False)
        for _ in range(num_tables)
    ])
    return idx.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _bit_tensors(params: FLANNParams, words: int, device: torch.device):
    """(word (L, B), shift (L, B), weight (B,)) int64 on ``device``."""
    idx = _bit_samples(params.num_tables, params.key_bits, words * 32,
                       params.seed).astype(np.int64)
    weight = np.left_shift(1, np.arange(params.key_bits, dtype=np.int64))
    return tuple(torch.as_tensor(a, device=device)
                 for a in (idx // 32, idx % 32, weight))


def _hash_keys(desc: torch.Tensor, params: FLANNParams) -> torch.Tensor:
    """(N, W) int32 descriptor words -> (N, L) int64 bucket keys."""
    word, shift, weight = _bit_tensors(params, desc.shape[1], desc.device)
    bits = (desc[:, word].to(torch.int64) >> shift) & 1  # (N, L, B)
    return torch.sum(bits * weight, dim=-1)


class LSHIndex(typing.NamedTuple):
    sorted_ids: torch.Tensor  # (L, N2) int32 train ids sorted by key per table
    # (L, 2^B + 2) int32 bucket start offsets: 2^B real buckets plus a
    # trailing overflow bucket (key 2^B) where masked train rows hash
    offsets: torch.Tensor
    desc: torch.Tensor  # (N2, W) the train bank (for candidate gathers)
    mask: torch.Tensor  # (N2,) train validity


def build_lsh_index(desc2: torch.Tensor, mask2: torch.Tensor,
                    params: FLANNParams = FLANNParams()) -> LSHIndex:
    """Bucket the train bank once (stable sorts and counts on its device)."""
    n_keys = 1 << params.key_bits
    keys = _hash_keys(desc2, params)  # (N2, L)
    # invalid rows hash to a dedicated overflow bucket past every real key
    keys = torch.where(mask2[:, None], keys, torch.full_like(keys, n_keys))
    keys_t = keys.T.contiguous()  # (L, N2)
    order = torch.argsort(keys_t, dim=1, stable=True)
    counts = torch.zeros((params.num_tables, n_keys + 1), dtype=torch.int64,
                         device=desc2.device)
    counts.scatter_add_(1, keys_t, torch.ones_like(keys_t))
    offsets = torch.cat(
        [torch.zeros((params.num_tables, 1), dtype=torch.int64,
                     device=desc2.device), torch.cumsum(counts, dim=1)],
        dim=1,
    )
    return LSHIndex(
        sorted_ids=order.to(torch.int32),
        offsets=offsets.to(torch.int32),
        desc=desc2,
        mask=mask2,
    )


def lsh_match(desc1: torch.Tensor, mask1: torch.Tensor, index: LSHIndex,
              params: FLANNParams = FLANNParams()):
    """Match queries against a built index.

    Returns ``(idx2 (N1,) int32, valid (N1,), diagnostics)``, the contract
    of the exact matcher's knn-ratio stage, so RANSAC and tracking
    downstream are shared.
    """
    L, C = params.num_tables, params.bucket_capacity
    qkeys = _hash_keys(desc1, params)  # (N1, L)
    N1 = desc1.shape[0]
    tables = torch.arange(L, device=desc1.device)
    offsets = index.offsets.to(torch.int64)
    starts = offsets[tables[None, :], qkeys]  # (N1, L)
    ends = offsets[tables[None, :], qkeys + 1]
    slots = starts[..., None] + torch.arange(C, device=desc1.device)
    cand_valid = slots < ends[..., None]  # (N1, L, C)
    slots = torch.clamp(slots, 0, index.sorted_ids.shape[1] - 1)
    cand = index.sorted_ids[tables[None, :, None], slots].to(torch.int64)
    cand = cand.reshape(N1, L * C)
    cand_valid = cand_valid.reshape(N1, L * C) & index.mask[cand]

    # Hamming over candidates only: (N1, L*C, W) XOR + popcount
    dist = popcount_words(torch.bitwise_xor(desc1[:, None, :],
                                            index.desc[cand]))
    big = torch.full((), BIG, dtype=torch.int32, device=dist.device)
    dist = torch.where(cand_valid, dist, big)

    best_pos = torch.argmin(dist, dim=1, keepdim=True)
    best = torch.gather(dist, 1, best_pos)[:, 0]
    best_id = torch.gather(cand, 1, best_pos)[:, 0]
    # dedupe: every entry of the best id is excluded before the second-best
    dist2 = torch.where(cand == best_id[:, None], big, dist)
    second = torch.min(dist2, dim=1)[0]

    valid = (
        mask1
        & (best < BIG)
        & (best.to(torch.float32)
           <= params.ratio_threshold * second.to(torch.float32))
    )
    diagnostics = {
        "num_candidates": torch.sum(cand_valid, dim=1),
        "num_good_matches": torch.sum(valid),
    }
    return best_id.to(torch.int32), valid, diagnostics
