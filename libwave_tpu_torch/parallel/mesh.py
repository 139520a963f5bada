"""Rank mesh construction over a ``torch.distributed`` process group.

Port of ``libwave_tpu.parallel.mesh``. The JAX package builds a
``jax.sharding.Mesh`` of devices and names its axes; ``shard_map`` code
then reduces over an axis by name. Here the ranks of a process group are
laid out as a (dp, tp) grid, ``tp`` innermost (rank = d * tp + t), and
each axis is an :class:`Axis`: the sub-group of the ranks that differ only
along it, with the collectives the solvers use (``psum``, tiled
``all_gather``, ``ppermute``). An :class:`Axis` is what the port passes
where the reference passes ``axis_name``.

Backends: a CUDA device means NCCL, the CPU gloo. Gloo may also be asked
for explicitly to put several ranks on one card; gloo's collectives then
run on host copies (the helper stages a CUDA tensor through the host and
back, which synchronizes). ``ppermute`` is a tiled all_gather followed by
a pick of the source rank's block on every backend: gloo has no
point-to-point transfer of CUDA tensors, the gather is exact (a copy), and
the blocks exchanged (pose-graph halos) are small.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 on dp means "all remaining ranks"."""

    dp: int = -1  # observation/factor-bank sharding
    tp: int = 1  # map-state (landmark-block) sharding

    def validate(self):
        if self.tp <= 0:
            raise ValueError("tp must be >= 1")


def rank_device(backend: str | None = None, local_rank: int | None = None,
                local_size: int | None = None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)``, or the CPU
    under gloo when no card is present. NCCL with more local ranks than
    cards raises: NCCL puts one rank on a card, and nothing falls back to
    the CPU."""
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else None)
    if local_rank is None:
        local_rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    if local_size is None:
        local_size = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            dist.get_world_size() if dist.is_initialized() else 1))
    if backend == "gloo" and not torch.cuda.is_available():
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_size > count:
        raise ValueError(f"NCCL puts one rank on a card: {local_size} local "
                         f"ranks, {count} CUDA devices")
    if count == 0:
        raise RuntimeError("no CUDA device for this rank")
    return torch.device("cuda", local_rank % count)


class Axis:
    """One mesh axis as seen by this rank: ``size`` ranks in ``group``
    (None: the default group), this rank at ``index``. ``live`` says
    whether its collectives run: by default when ``size > 1``; a size-1
    axis spanning a one-rank process group runs them too (through that
    group's backend), any other size-1 axis treats them as identities."""

    def __init__(self, name, size: int, index: int, group=None,
                 stage: bool = False, live: bool | None = None):
        self.name = name
        self.size = size
        self.index = index
        self.group = group
        self.stage = stage  # gloo on a CUDA tensor: collective on a host copy
        self.live = size > 1 if live is None else live

    def __repr__(self):
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def _host(self, x):
        return x.cpu() if self.stage and x.is_cuda else x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the axis (``all_reduce``), on every rank."""
        if not self.live:
            return x
        y = self._host(x).clone().contiguous()
        dist.all_reduce(y, group=self.group)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in axis order (the
        reference's ``all_gather(..., tiled=True)``)."""
        if not self.live:
            return x
        h = self._host(x).contiguous()
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute``: for each (src, dst) pair of axis indices,
        dst receives src's ``x``; a rank that receives nothing gets zeros.
        A tiled all_gather, then this rank's source block."""
        src = {d: s for s, d in perm}
        if self.index not in src:
            return torch.zeros_like(x)
        if not self.live:
            return x
        return self.all_gather(x[None])[src[self.index]]


class Sharding(NamedTuple):
    """The reduction axes of blocks whose landmark rows are cut into
    chunks (the one-step's ``tp`` sharding): pose-side sums and the cost
    reduce over ``pose`` (every rank), landmark-side sums over ``lm`` (the
    ranks that hold the same chunk), and a scalar over landmark rows over
    ``chunk`` (one rank of each chunk; None when there is one chunk). The
    solvers take a plain :class:`Axis` as all of these at once."""

    pose: Axis
    lm: Axis
    chunk: Axis | None = None


class Mesh:
    """A grid of ranks with named axes. ``ranks`` is the grid of global
    ranks (the reference's ``mesh.devices``), ``shape`` maps each axis
    name to its size, ``device`` is this rank's device and ``backend`` the
    process group's (None for a single process with no group)."""

    def __init__(self, ranks: np.ndarray, axis_names, device, backend,
                 axes: dict, group=None):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = device
        self.backend = backend
        self.group = group
        self._axes = axes

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis(self, name) -> Axis:
        """The :class:`Axis` of ``name``: one of ``axis_names``, or the
        tuple of all of them (every rank of the mesh)."""
        if name not in self._axes:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self._axes[name]


def _stage(backend, device) -> bool:
    return backend == "gloo" and torch.device(device).type == "cuda"


def _group_of(line, group):
    """The process group of the ranks ``line``: the default group or
    ``group`` when it is exactly their ranks, else a new group (made
    collectively: every rank of the world calls this for every line)."""
    line = [int(r) for r in line]
    if group is None and line == list(range(dist.get_world_size())):
        return None
    if group is not None and line == dist.get_process_group_ranks(group):
        return group
    return dist.new_group(line)


def _build(ranks: np.ndarray, axis_names, device, group) -> Mesh:
    """The :class:`Mesh` of the rank grid ``ranks``; every rank of the
    world runs this with the same grid (sub-groups are made collectively,
    in one order on every rank). Besides each named axis, the tuple of all
    names is an axis over every rank of the mesh, in grid order."""
    backend = dist.get_backend(group) if dist.is_initialized() else None
    me = dist.get_rank() if dist.is_initialized() else int(ranks.flat[0])
    where = np.argwhere(ranks == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} is not in the mesh {ranks.tolist()}")
    pos = tuple(int(i) for i in where[0])
    stage = _stage(backend, device)
    # a one-rank process group: its one axis line runs the collectives
    solo = dist.is_initialized() and dist.get_world_size(group) == 1
    axes = {}
    for a, name in enumerate(axis_names):
        size = ranks.shape[a]
        mine = None
        if size > 1:
            for line in np.moveaxis(ranks, a, -1).reshape(-1, size):
                g = _group_of(line, group)
                if me in line:
                    mine = g
        axes[name] = Axis(name, size, pos[a], mine if size > 1 else group,
                          stage, size > 1 or solo)
    names = tuple(axis_names)
    if len(names) == 1:
        axes[names] = axes[names[0]]
    else:
        flat = ranks.reshape(-1)
        axes[names] = Axis(names, flat.size,
                           int(np.flatnonzero(flat == me)[0]),
                           _group_of(flat, group) if flat.size > 1 else group,
                           stage, flat.size > 1 or solo)
    return Mesh(ranks, axis_names, device, backend, axes, group)


def make_mesh(config: MeshConfig = MeshConfig(), device=None,
              group=None) -> Mesh:
    """Build a 2D ('dp', 'tp') mesh over the ranks of ``group`` (default:
    the default process group; without one, a single-rank mesh whose
    collectives are identities). ``tp`` is innermost. ``device`` is this
    rank's device (default :func:`rank_device`). Every rank of the group
    must call this, in the same order as its other group creations."""
    config.validate()
    if dist.is_initialized():
        n = dist.get_world_size(group)
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(n)))
    else:
        n, ranks = 1, [0]
    tp = config.tp
    dp = config.dp if config.dp > 0 else n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} ranks")
    device = rank_device() if device is None else torch.device(device)
    return _build(np.asarray(ranks).reshape(dp, tp), ("dp", "tp"), device,
                  group)
