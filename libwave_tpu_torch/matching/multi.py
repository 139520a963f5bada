"""Batched multi-matching: N registrations in flight at once.

Port of ``libwave_tpu.matching.multi``. The reference's ``MultiMatcher``
thread pool is, in the JAX package, a ``vmap`` over pairs; in the port the
matchers themselves take a leading batch dimension, so the batch of pairs
is one call.
"""

from __future__ import annotations

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
    """The multi-device placement of pairs over a mesh: not ported yet. It
    moves to ``torch.distributed`` with the rest of ``parallel/*``
    (ROADMAP.md A.8)."""
    raise NotImplementedError(
        "multi_match_sharded: placing pairs over a device mesh moves to "
        "torch.distributed with parallel/* (ROADMAP.md A.8); call "
        "multi_match on one card")
