"""Batched multi-matching: N registrations in flight at once.

Port of ``libwave_tpu.matching.multi``. The reference's ``MultiMatcher``
thread pool is, in the JAX package, a ``vmap`` over pairs; in the port the
matchers themselves take a leading batch dimension, so the batch of pairs
is one call. :func:`multi_match_sharded` spreads the pairs over the ranks
of a mesh axis (``parallel.mesh``).
"""

from __future__ import annotations

import torch

from libwave_tpu_torch.matching.icp import ICPParams, icp_match
from libwave_tpu_torch.matching.pointcloud import PointCloud


def multi_match(refs: PointCloud, targets: PointCloud,
                params: ICPParams = ICPParams(), matcher=icp_match):
    """Register a batch of pairs: ``refs``/``targets`` carry a leading
    batch axis on points (B, N, 3) and mask (B, N). Returns the matcher's
    result with leading batch dimensions."""
    return matcher(refs, targets, params)


def multi_match_sharded(refs: PointCloud, targets: PointCloud, mesh,
                        params: ICPParams = ICPParams(), matcher=icp_match,
                        axis_name: str = "dp"):
    """The MultiMatcher's multi-rank form: the pair batch is split over
    the ranks of ``mesh``'s axis ``axis_name``, each rank registering its
    B/R contiguous pairs on ``mesh.device`` through :func:`multi_match`
    (every pair is independent: no collective on the matching itself).
    Every rank passes the whole batch; the batch size must be divisible by
    the axis size (pad with masked pairs).

    PyTorch has no global sharded tensor, so the per-rank results are then
    all_gathered: every rank returns the whole batch's result, in batch
    order (the reference returns one array sharded over the mesh)."""
    B = refs.points.shape[0]
    axis = mesh.axis(axis_name)
    if B % axis.size != 0:
        raise ValueError(
            f"batch of {B} pairs must be divisible by the {axis.size} ranks "
            f"on mesh axis '{axis_name}'; pad with masked pairs"
        )
    b = B // axis.size
    lo = axis.index * b

    def mine(cloud):
        return PointCloud(points=cloud.points[lo:lo + b].to(mesh.device),
                          mask=cloud.mask[lo:lo + b].to(mesh.device))

    return _gather(axis, multi_match(mine(refs), mine(targets), params,
                                     matcher))


def _gather(axis, x):
    """All-gather every tensor of a (nested) NamedTuple result along its
    batch axis; bool tensors travel as uint8."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return axis.all_gather(x.to(torch.uint8)).bool()
        return axis.all_gather(x)
    return type(x)(*(_gather(axis, v) for v in x))
