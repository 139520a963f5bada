"""Multi-host process groups and host-spanning meshes.

Port of ``libwave_tpu.parallel.multihost``. The reference creates a
``jax.distributed`` process group and a mesh whose outer axis spans hosts
(DCN) and inner axis a host's devices (ICI). Here the process group is
``torch.distributed``'s, one process per rank, and the mesh is a grid of
ranks: (nodes, local ranks) as ``("dcn", "ici")``.

With one process every function below is a no-op or identity, so the same
launch script runs on one card and on many.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from libwave_tpu_torch.optim.ba import BAConfig, BAProblem, BAState
from libwave_tpu_torch.parallel.dist_ba import (
    partition_ba_problem,
    solve_ba_sharded,
)
from libwave_tpu_torch.parallel.mesh import Mesh, _build, rank_device


@dataclasses.dataclass(frozen=True)
class MultiHostConfig:
    """Process-group wiring. Defaults describe a single-process run.

    For an R-process launch, start every process with the same
    ``coordinator_address`` (an ``init_method`` URL:
    ``tcp://host:port`` of process 0, or ``file:///path`` of a shared
    file) and ``num_processes``, and its own ``process_id``. All three
    None: the launcher's environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) decides, as ``torch.distributed``'s ``env://``.
    ``local_device_ids``: the CUDA devices of this host's ranks, in local
    rank order (default: local rank modulo the device count)."""

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    local_device_ids: tuple | None = None

    def validate(self):
        explicit = (
            self.coordinator_address is not None
            or self.num_processes is not None
            or self.process_id is not None
        )
        if explicit and (
            self.coordinator_address is None
            or self.num_processes is None
            or self.process_id is None
        ):
            raise ValueError(
                "coordinator_address, num_processes and process_id must be "
                "set together (or all left None for autodetection)"
            )


def initialize_multihost(cfg: MultiHostConfig = MultiHostConfig(),
                         backend: str | None = None) -> bool:
    """Create the process group (``torch.distributed.init_process_group``).
    Call once per process. Returns True when a multi-process group exists
    afterwards, False for the single-process case, where nothing is
    initialized.

    ``backend``: NCCL when this process has a card, gloo otherwise; ask
    for gloo explicitly to put several ranks on one card (NCCL puts one
    rank on a card, and more NCCL ranks than cards raise)."""
    cfg.validate()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if cfg.coordinator_address is None and cfg.num_processes in (None, 1) \
            and env_world == 1:
        return False  # one process: nothing to initialize
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if cfg.coordinator_address is not None:
        kwargs = dict(init_method=cfg.coordinator_address,
                      world_size=cfg.num_processes, rank=cfg.process_id)
    world = cfg.num_processes or env_world
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        device = rank_device("nccl", local_rank=_local_rank(cfg),
                             local_size=local)
        if cfg.local_device_ids is not None:
            device = torch.device("cuda", cfg.local_device_ids[
                _local_rank(cfg) % len(cfg.local_device_ids)])
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)
    return dist.get_world_size() > 1


def _local_rank(cfg: MultiHostConfig) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return cfg.process_id if cfg.process_id is not None \
        else int(os.environ.get("RANK", "0"))


def make_host_mesh(axis_names=("dcn", "ici"), device=None) -> Mesh:
    """(hosts, local ranks) mesh: the outer axis crosses hosts, the inner
    axis stays within a host. Ranks are host-major (``LOCAL_WORLD_SIZE``
    ranks per host, every rank when unset), so a contiguous block
    partition keeps neighbours on one host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    device = rank_device() if device is None else torch.device(device)
    ranks = np.arange(world).reshape(world // local, local)
    return _build(ranks, axis_names, device, None)


def flatten_mesh(mesh: Mesh, axis_name: str = "dp") -> Mesh:
    """Collapse a mesh into one 1-D axis, rank order preserved (host-major):
    the block-partitioned solvers shard over a single named axis."""
    return _build(mesh.ranks.reshape(-1), (axis_name,), mesh.device,
                  mesh.group)


def host_block_range(n_items: int, mesh: Mesh | None = None):
    """[lo, hi) block of a length-``n_items`` partition owned by THIS
    process under contiguous block sharding: what a per-process data
    loader should read so no process touches the full dataset."""
    procs = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n_items // procs)
    return me * per, min(n_items, (me + 1) * per)


def solve_ba_multihost(
    problem: BAProblem,
    state: BAState,
    cfg: BAConfig = BAConfig(),
    mesh: Mesh | None = None,
):
    """Distributed BA over every rank of every host: contiguous pose
    blocks, one per rank, host-major placement (the landmark psums are the
    only traffic between hosts). With one process this is
    :func:`solve_ba_sharded` on one rank. Returns (state, info)."""
    if mesh is None:
        mesh = flatten_mesh(make_host_mesh())
    elif len(mesh.axis_names) > 1:
        mesh = flatten_mesh(mesh)
    axis = mesh.axis_names[0]
    stacked, padded = partition_ba_problem(problem, state, mesh.size,
                                           device=mesh.device)
    return solve_ba_sharded(stacked, padded, mesh, cfg, axis_name=axis)
