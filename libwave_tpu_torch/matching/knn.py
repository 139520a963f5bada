"""Nearest-neighbour search as chunked matrix products.

Port of ``libwave_tpu.matching.knn``: squared distances
``|p|^2 - 2 p.q + |q|^2`` per target chunk with a running (min, argmin) or
running top-k, batched over leading dimensions (``(..., N, 3)`` queries
against ``(..., M, 3)`` targets). The distance cancels, so the products run
in full f32 (TF32 would change which neighbour wins).
"""

from __future__ import annotations

import torch

from libwave_tpu_torch.utils.precision import f32_matmuls

_INF = float("inf")


def _chunks(target, target_mask, chunk):
    """Pad the targets to whole chunks; yields (offset, t, tm, |t|^2)."""
    M = target.shape[-2]
    chunk = min(chunk, M)
    num_chunks = -(-M // chunk)
    pad = num_chunks * chunk - M
    if pad:
        target = torch.cat(
            [target, target.new_zeros(target.shape[:-2] + (pad, 3))], dim=-2)
        target_mask = torch.cat(
            [target_mask,
             target_mask.new_zeros(target_mask.shape[:-1] + (pad,))], dim=-1)
    for c in range(num_chunks):
        t = target[..., c * chunk:(c + 1) * chunk, :]
        tm = target_mask[..., c * chunk:(c + 1) * chunk]
        yield c * chunk, t, tm, torch.sum(t * t, dim=-1)


def _d2(query, q2, t, tm, t2):
    d2 = q2[..., :, None] - 2.0 * (query @ t.transpose(-1, -2)) \
        + t2[..., None, :]
    return torch.where(tm[..., None, :], d2, _INF)


@f32_matmuls
def nearest_neighbor(query, query_mask, target, target_mask,
                     chunk: int = 2048):
    """For each query point, index + squared distance of its nearest valid
    target point. Returns (idx (..., N) int32, dist2 (..., N)); masked
    queries get dist2 inf. Ties go to the lower index, as ``jnp.argmin``
    and the reference's strict running comparison give them."""
    q2 = torch.sum(query * query, dim=-1)
    best_d = torch.full(q2.shape, _INF, dtype=query.dtype,
                        device=query.device)
    best_i = torch.zeros(q2.shape, dtype=torch.int32, device=query.device)
    for off, t, tm, t2 in _chunks(target, target_mask, chunk):
        d, i = torch.min(_d2(query, q2, t, tm, t2), dim=-1)
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, (i + off).to(torch.int32), best_i)
    best_d = torch.where(query_mask, best_d, _INF)
    return best_i, torch.clamp(best_d, min=0.0)


@f32_matmuls
def knn(query, query_mask, target, target_mask, k: int, chunk: int = 2048):
    """k nearest valid targets per query. Returns (idx (..., N, k) int32,
    dist2 (..., N, k)). The running top-k is a stable sort of the carried k
    and the chunk's distances: ties go to the lower index, as
    ``lax.top_k``'s do."""
    q2 = torch.sum(query * query, dim=-1)
    best_d = torch.full(q2.shape + (k,), _INF, dtype=query.dtype,
                        device=query.device)
    best_i = torch.zeros(q2.shape + (k,), dtype=torch.int32,
                         device=query.device)
    for off, t, tm, t2 in _chunks(target, target_mask, chunk):
        d2 = _d2(query, q2, t, tm, t2)
        ii = torch.arange(off, off + d2.shape[-1], dtype=torch.int32,
                          device=d2.device).expand(d2.shape)
        cat_d = torch.cat([best_d, d2], dim=-1)
        cat_i = torch.cat([best_i, ii], dim=-1)
        best_d, sel = torch.sort(cat_d, dim=-1, stable=True)
        best_d = best_d[..., :k]
        best_i = torch.take_along_dim(cat_i, sel[..., :k], dim=-1)
    best_d = torch.where(query_mask[..., None], best_d, _INF)
    return best_i, torch.clamp(best_d, min=0.0)
