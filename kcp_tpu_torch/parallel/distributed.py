"""Multi-process bring-up: the ``torch.distributed`` process group and the
topology-derived serving mesh (the port of
``kcp_tpu.parallel.distributed``).

``init_distributed`` assembles the process-group arguments from explicit
args or the ``torch.distributed`` environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and forms the group. An
explicit single process is a no-op. Every process of the group runs the
same server and drives the same ticks (the reference's multi-controller
program): each holds only its own ``hosts`` block of row shards, and the
sharded step's cross-shard reductions go through collectives on the group
(``parallel/mesh.py`` ``all_sum``, ``gather_blocks``), so every process
assembles the same wire. ``pod_serving_mesh`` is the ``"auto"`` spec:
hosts-major over the group's processes, or a flat tenants mesh in one
process.
"""

from __future__ import annotations

import datetime
import logging
import os

from .mesh import Mesh, _as_devices, _group, _visible_devices, make_mesh, make_multihost_mesh

log = logging.getLogger(__name__)

#: seconds a collective (and the group's formation) may wait for the other
#: processes before it fails instead of hanging
DIST_TIMEOUT_S = 120.0


def _local_ranks(world: int, rank: int) -> tuple[int, int]:
    """(processes on this host, this process's index among them): the
    launcher's ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``, else every process of
    the group on this host."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return local_world, int(os.environ.get("LOCAL_RANK", rank % local_world))


def _rank_devices(devs: list, world: int, rank: int) -> list:
    """This process's share of the host's cards: an equal block each when
    there are as many cards as processes on the host, else one card
    (shared) each."""
    local_world, local_rank = _local_ranks(world, rank)
    if len(devs) >= local_world:
        per = len(devs) // local_world
        return devs[local_rank * per:(local_rank + 1) * per]
    return [devs[local_rank % len(devs)]]


def _backend(world: int, rank: int, device=None) -> str:
    """NCCL when each process of this host has a card of its own, gloo
    otherwise (one card shared by several processes, or the CPU)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if n and n >= _local_ranks(world, rank)[0] else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None,
                     _dry_run: bool = False) -> dict:
    """Form the ``torch.distributed`` process group (idempotent); returns
    the kwargs used.

    Explicit args win; otherwise ``MASTER_ADDR``:``MASTER_PORT`` (as a
    ``tcp://`` init method), ``WORLD_SIZE`` and ``RANK``. ``_dry_run``
    only assembles (the argument tests). An explicit single process is a
    no-op. The backend is NCCL when each process of this host has a card
    of its own, gloo otherwise (``device`` is the serving device the caller
    asked for, if any: the CPU takes gloo); every collective fails after
    :data:`DIST_TIMEOUT_S` instead of hanging.
    """
    kwargs: dict = {}
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator:
        kwargs["init_method"] = (coordinator if "://" in coordinator
                                 else f"tcp://{coordinator}")
    n = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    if n is not None:
        kwargs["world_size"] = int(n)
    pid = process_id if process_id is not None else os.environ.get("RANK")
    if pid is not None:
        kwargs["rank"] = int(pid)
    if _dry_run:
        return kwargs
    if kwargs.get("world_size") == 1:
        log.info("explicit single-process serving; no process group")
        return kwargs
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        log.info("process group already formed; skipping init_process_group")
        return kwargs
    world, rank = kwargs.get("world_size", 1), kwargs.get("rank", 0)
    backend = _backend(world, rank, device)
    if backend == "nccl":
        torch.cuda.set_device(_rank_devices(_visible_devices(), world, rank)[0])
    dist.init_process_group(backend=backend,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kwargs)
    log.info("process group up (%s): process %d/%d", backend, dist.get_rank(),
             dist.get_world_size())
    return kwargs


def pod_serving_mesh(slots: int = 1, devices: list | None = None) -> Mesh:
    """The ``"auto"`` serving mesh over the live topology: in a group of
    more than one process, hosts-major (``hosts`` = the world size, this
    process's hosts block the rank's, tenants over its devices); else flat
    tenants over this process's devices. ``devices`` are this process's
    (default: its share of the visible CUDA devices; raises without a
    card)."""
    world, rank = _group()
    if devices is not None:
        devs = _as_devices(devices)
    else:
        devs = _visible_devices()
        if world > 1:
            devs = _rank_devices(devs, world, rank)
    if slots < 1 or len(devs) % slots:
        raise ValueError(
            f"slots={slots} does not divide this process's {len(devs)} devices; "
            f"pick a slots axis that divides the per-process device count")
    if world > 1:
        return make_multihost_mesh(hosts=world, slots=slots, devices=devs, process=rank)
    return make_mesh(slots=slots, devices=devs)
