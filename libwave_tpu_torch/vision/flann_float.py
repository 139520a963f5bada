"""Float-descriptor matching indexes: the FLANNMatcher KDTree / KMeans /
Composite analogs (port of ``libwave_tpu.vision.flann_float``).

The reference's ``FLANNMatcher`` float-index methods
(wave_vision/include/wave/vision/matcher/flann_matcher.hpp:39-51:
``KDTree`` randomized kd-forest, ``KMeans`` hierarchical k-means tree,
``Composite`` both combined) generate sub-linear candidate sets for
SIFT/SURF-class descriptors, then score the candidates with true L2. Each
method keeps its FLANN role with an index that is plain tensors:

- ``exact``: no index, the full top-2 L2 search as matrix products
  (``|q - t|^2 = |q|^2 + |t|^2 - 2 q.t``), in chunks of query rows;
- ``kdtree``: ``num_trees`` random projection partitions, each hashing a
  descriptor to the sign bits of ``key_bits`` projections of mean-centred
  data (the dense analog of kd-splits);
- ``kmeans``: a one-level inverted file of ``2 ^ key_bits`` Lloyd
  centroids; queries probe their ``num_probes`` nearest cells;
- ``composite``: the union of both candidate sets (FLANN's
  CompositeIndex).

Buckets are fixed-capacity slices of a stably sorted id table, as in the
binary LSH index; candidates are scored with exact L2 and the Lowe ratio
test, deduplicated across tables.

What the port keeps equal to the JAX package: the random projections and
the k-means start rows are the same numpy ``default_rng`` draws, so they
are equal bit for bit; every product runs in full f32 (TF32 off), since
the distances cancel; the Lloyd sums go through the port's fixed-order
segment reduce (``ops.segmm.seg_reduce``: on the card the
``csrc/segmm_seg.cu`` kernel, no atomics), so a build gives the same
centroids on every run; the bucket table is a stable sort, and a query's
probe order keeps ``lax.top_k``'s lower-index-first order on ties.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from libwave_tpu_torch.ops import segmm
from libwave_tpu_torch.utils.config import ConfigError
from libwave_tpu_torch.utils.precision import f32_matmuls

__all__ = [
    "FloatIndexParams",
    "FloatIndex",
    "build_float_index",
    "float_match",
    "exact_l2_top2",
]

_BIG = float(np.float32(3.4e38))
# Query rows per chunk: at most this many distance (or candidate
# coordinate) elements at once.
_CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class FloatIndexParams:
    """flann_matcher.hpp:39-51 method selection + the knobs each method
    has in FLANN (trees, branching, iterations, checks -> here the static
    candidate budget ``bucket_capacity``)."""

    method: str = "exact"  # exact | kdtree | kmeans | composite
    num_trees: int = 4  # kd-forest size (FLANN KDTreeIndexParams trees=4)
    key_bits: int = 8  # projections per tree / log2(kmeans branching)
    kmeans_iterations: int = 8  # Lloyd iterations (FLANN default 11 caps)
    num_probes: int = 4  # kmeans cells probed per query
    bucket_capacity: int = 64  # candidates retained per bucket
    ratio_threshold: float = 0.8  # Lowe ratio (DescriptorMatcher default)
    seed: int = 5489  # reference FLANN's default RNG seed

    def validate(self):
        if self.method not in ("exact", "kdtree", "kmeans", "composite"):
            raise ConfigError(
                "method must be exact | kdtree | kmeans | composite"
            )
        if self.num_trees <= 0:
            raise ConfigError("num_trees must be positive")
        if not 1 <= self.key_bits <= 16:
            raise ConfigError("key_bits must be in [1, 16]")
        if self.kmeans_iterations <= 0:
            raise ConfigError("kmeans_iterations must be positive")
        if self.num_probes <= 0:
            raise ConfigError("num_probes must be positive")
        if self.bucket_capacity <= 1:
            raise ConfigError("bucket_capacity must be > 1")
        if not 0 < self.ratio_threshold <= 1:
            raise ConfigError("ratio_threshold must be in (0, 1]")


def _sq_dists(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N1, D) x (N2, D) -> (N1, N2) squared L2 by the product identity."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    tt = torch.sum(t * t, dim=-1)
    return torch.clamp(qq + tt[None, :] - 2.0 * (q @ t.T), min=0.0)


def _row_chunks(n_rows: int, per_row: int):
    """Slices of query rows, each holding at most ``_CHUNK_ELEMENTS``."""
    step = max(1, _CHUNK_ELEMENTS // max(per_row, 1))
    return [slice(k, k + step) for k in range(0, n_rows, step)]


def _ratio_valid(mask1, best, second, ratio_threshold):
    # FLANN/OpenCV ratio-test convention on L2 distances (not squared)
    return (mask1 & (best < _BIG)
            & (torch.sqrt(best) <= ratio_threshold * torch.sqrt(second)))


def _exact_rows(desc1, desc2, mask2):
    d = _sq_dists(desc1, desc2)
    d = torch.where(mask2[None, :], d, _BIG)
    best_id = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_id[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.min(torch.where(cols[None, :] == best_id[:, None],
                                   _BIG, d), dim=1)[0]
    return best_id.to(torch.int32), best, second


@f32_matmuls
def exact_l2_top2(desc1, mask1, desc2, mask2, ratio_threshold=0.8):
    """Dense exact float matcher: top-2 L2 + Lowe ratio, as matrix
    products over chunks of query rows.

    Returns ``(idx2 (N1,) int32, valid (N1,), diagnostics)``, the shared
    matcher contract (vision.matcher / vision.flann)."""
    parts = [_exact_rows(desc1[rows], desc2, mask2)
             for rows in _row_chunks(desc1.shape[0], desc2.shape[0])]
    best_id, best, second = (torch.cat(p) for p in zip(*parts))
    valid = _ratio_valid(mask1, best, second, ratio_threshold)
    return best_id, valid, {"num_good_matches": torch.sum(valid)}


def _bucket_table(keys_t: torch.Tensor, n_keys: int):
    """(L, N2) integer keys -> (sorted_ids (L, N2), offsets (L, n_keys+2)),
    int32. Key ``n_keys`` is the overflow bucket for masked rows (queries
    never look it up). Same machinery as the binary LSH index."""
    keys_t = keys_t.long()
    order = torch.argsort(keys_t, dim=1, stable=True)
    L = keys_t.shape[0]
    counts = torch.zeros((L, n_keys + 1), dtype=torch.int64,
                         device=keys_t.device)
    counts.scatter_add_(1, keys_t, torch.ones_like(keys_t))
    offsets = torch.cat(
        [torch.zeros((L, 1), dtype=torch.int64, device=keys_t.device),
         torch.cumsum(counts, dim=1)], dim=1)
    return order.to(torch.int32), offsets.to(torch.int32)


@functools.lru_cache(maxsize=16)
def _kd_projections_numpy(num_trees: int, key_bits: int, dim: int,
                          seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(num_trees, key_bits, dim))
    P /= np.linalg.norm(P, axis=-1, keepdims=True)
    return P.astype(np.float32)


def _kd_projections(params: FloatIndexParams, dim: int, device):
    """Static random projection directions for the kd-forest analog:
    (num_trees, key_bits, dim) f32, unit rows, the JAX package's numpy
    draw from the seed."""
    return torch.as_tensor(_kd_projections_numpy(
        params.num_trees, params.key_bits, dim, params.seed), device=device)


def _kd_keys(desc, center, proj):
    """Sign-bit keys of mean-centred projections: (N, L) int32."""
    z = torch.einsum("lbd,nd->nlb", proj, desc - center[None, :])
    bits = (z > 0).to(torch.int32)  # (N, L, B)
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=desc.device),
        torch.arange(bits.shape[-1], dtype=torch.int32, device=desc.device))
    return torch.sum(bits * weights[None, None, :], dim=-1,
                     dtype=torch.int32)


def _kmeans_init_rows(n_rows: int, n_clusters: int, seed: int) -> np.ndarray:
    """The k-means start rows: the JAX package's numpy draw."""
    rng = np.random.default_rng(seed)
    return rng.choice(n_rows, size=n_clusters, replace=n_rows < n_clusters)


def _fit_kmeans(desc, mask, n_clusters: int, iters: int, seed: int):
    """Batched Lloyd: centroids (n_clusters, D). Starts from the seed's
    rows; empty clusters keep their previous mean. Each iteration's sums
    (and counts, as one more channel) are one fixed-order segment reduce
    over (D + 1, N)."""
    N, D = desc.shape
    init_rows = torch.as_tensor(_kmeans_init_rows(N, n_clusters, seed),
                                device=desc.device)
    C = desc[init_rows]
    w = mask.to(desc.dtype)
    weighted = torch.cat([(desc * w[:, None]).T, w[None, :]]).contiguous()
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(desc, C), dim=1).to(torch.int32)
        sums = segmm.seg_reduce(weighted, assign, n_clusters)  # (D+1, K)
        cnt = sums[D]
        C = torch.where(cnt[:, None] > 0,
                        sums[:D].T / torch.clamp(cnt, min=1.0)[:, None], C)
    return C


class FloatIndex(typing.NamedTuple):
    """Float index as tensors: bucket tables per partition (kd trees
    and/or k-means cells), plus what each method needs to key a query.
    The method is ``FloatIndexParams.method``."""

    sorted_ids: torch.Tensor  # (L_total, N2) int32
    offsets: torch.Tensor  # (L_total, n_keys + 2) int32
    desc: torch.Tensor  # (N2, D) train bank, f32
    mask: torch.Tensor  # (N2,)
    center: torch.Tensor  # (D,) projection centring (kdtree rows)
    centroids: torch.Tensor  # (n_clusters, D) or (0, D)


@f32_matmuls
def build_float_index(desc2: torch.Tensor, mask2: torch.Tensor,
                      params: FloatIndexParams = FloatIndexParams()
                      ) -> FloatIndex:
    """Build the selected float index over a train bank on its device."""
    params.validate()
    desc2 = desc2.to(torch.float32)
    N2, D = desc2.shape
    n_keys = 1 << params.key_bits
    use_kd = params.method in ("kdtree", "composite")
    use_km = params.method in ("kmeans", "composite")

    w = mask2.to(desc2.dtype)
    denom = torch.clamp(torch.sum(w), min=1.0)
    center = torch.sum(desc2 * w[:, None], dim=0) / denom

    key_rows = []
    if use_kd:
        proj = _kd_projections(params, D, desc2.device)
        key_rows.append(_kd_keys(desc2, center, proj).T)  # (L_kd, N2)
    centroids = desc2.new_zeros((0, D))
    if use_km:
        centroids = _fit_kmeans(
            desc2, mask2, n_keys, params.kmeans_iterations, params.seed
        )
        assign = torch.argmin(_sq_dists(desc2, centroids), dim=1)
        key_rows.append(assign[None, :].to(torch.int32))  # (1, N2)
    if not key_rows:  # exact: a 1-bucket table so shapes stay fixed
        key_rows.append(torch.zeros((1, N2), dtype=torch.int32,
                                    device=desc2.device))

    keys_t = torch.cat(key_rows, dim=0)
    keys_t = torch.where(mask2[None, :], keys_t, n_keys)
    sorted_ids, offsets = _bucket_table(keys_t, n_keys)
    return FloatIndex(
        sorted_ids=sorted_ids,
        offsets=offsets,
        desc=desc2,
        mask=mask2,
        center=center,
        centroids=centroids,
    )


def _candidate_rows(desc1, mask1, qkeys, table_of_col, index, C,
                    ratio_threshold):
    """Score one chunk of queries against their bucket candidates."""
    N1, T = qkeys.shape
    offsets = index.offsets.long()
    starts = offsets[table_of_col[None, :], qkeys]  # (N1, T)
    ends = offsets[table_of_col[None, :], qkeys + 1]
    span = torch.arange(C, device=desc1.device)
    slots = starts[..., None] + span[None, None, :]  # (N1, T, C)
    cand_valid = slots < ends[..., None]
    slots = torch.clamp(slots, 0, index.sorted_ids.shape[1] - 1)
    cand = index.sorted_ids[table_of_col[None, :, None], slots].long()
    cand = cand.reshape(N1, T * C)
    cand_valid = cand_valid.reshape(N1, T * C) & index.mask[cand]

    # exact L2 on candidates only
    diff = desc1[:, None, :] - index.desc[cand]
    dist = torch.sum(diff * diff, dim=-1)
    dist = torch.where(cand_valid, dist, _BIG)

    best_pos = torch.argmin(dist, dim=1, keepdim=True)
    best = torch.gather(dist, 1, best_pos)[:, 0]
    best_id = torch.gather(cand, 1, best_pos)[:, 0]
    # dedupe across tables before the ratio test (as in the binary LSH)
    second = torch.min(torch.where(cand == best_id[:, None], _BIG, dist),
                       dim=1)[0]
    valid = _ratio_valid(mask1, best, second, ratio_threshold)
    return best_id.to(torch.int32), valid, torch.sum(cand_valid, dim=1)


@f32_matmuls
def float_match(desc1: torch.Tensor, mask1: torch.Tensor, index: FloatIndex,
                params: FloatIndexParams = FloatIndexParams()):
    """Match float queries against a built index.

    Returns ``(idx2 (N1,) int32, valid (N1,), diagnostics)``, the shared
    matcher contract. ``method="exact"`` ignores the bucket tables and runs
    the dense search."""
    desc1 = desc1.to(torch.float32)
    if params.method == "exact":
        return exact_l2_top2(
            desc1, mask1, index.desc, index.mask, params.ratio_threshold
        )

    C = params.bucket_capacity
    dev = desc1.device
    use_kd = params.method in ("kdtree", "composite")
    use_km = params.method in ("kmeans", "composite")

    # query keys per table, in the build's row order
    qkey_rows = []
    if use_kd:
        proj = _kd_projections(params, desc1.shape[1], dev)
        qkey_rows.append(_kd_keys(desc1, index.center, proj))  # (N1, L_kd)
    probes = 1
    if use_km:
        # the num_probes nearest cells (FLANN's best-bin-first descent
        # analog); a stable ascending sort keeps lax.top_k's tie order
        probes = min(params.num_probes, index.centroids.shape[0])
        dcell = _sq_dists(desc1, index.centroids)
        cells = torch.sort(dcell, dim=1, stable=True)[1][:, :probes]
        qkey_rows.append(cells.to(torch.int32))
    qkeys = torch.cat(qkey_rows, dim=1).long()  # (N1, T)

    # the build's table row for every query key column: kd trees map 1:1,
    # every k-means probe hits the single k-means table row
    n_kd = params.num_trees if use_kd else 0
    table_of_col = torch.cat([
        torch.arange(n_kd, device=dev),
        torch.full((probes if use_km else 0,), n_kd, device=dev),
    ]).long()

    per_row = qkeys.shape[1] * C * desc1.shape[1]
    parts = [_candidate_rows(desc1[rows], mask1[rows], qkeys[rows],
                             table_of_col, index, C, params.ratio_threshold)
             for rows in _row_chunks(desc1.shape[0], per_row)]
    best_id, valid, num_candidates = (torch.cat(p) for p in zip(*parts))
    diagnostics = {
        "num_candidates": num_candidates,
        "num_good_matches": torch.sum(valid),
    }
    return best_id, valid, diagnostics
