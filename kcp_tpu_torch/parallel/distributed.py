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
from typing import NamedTuple

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


class RankPlan(NamedTuple):
    """What one process of the group serves on: the group's backend and
    this process's devices (its mesh blocks' default device list)."""

    backend: str
    devices: list


def rank_plan(world: int, rank: int, device=None) -> RankPlan:
    """THE rule for a process's backend and serving devices, read by
    :func:`init_distributed` and by every mesh a process of the group
    builds from the visible cards (``mesh_from_spec``, ``"auto"``).

    NCCL only where this process serves on cards that no other process of
    the host serves on, since NCCL refuses two ranks on one card; then its
    devices are an equal block of the visible cards (``device`` None or a
    bare ``"cuda"``, as many cards as processes on the host or more), or
    the one card it names when it is the host's only process. gloo
    otherwise: a named card shared by several processes of the host (each
    process knows only its own ``device``, so a named card counts as
    shared), fewer cards than processes (one card each, shared), the CPU,
    or no card (no devices)."""
    import torch

    local_world, local_rank = _local_ranks(world, rank)
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return RankPlan("gloo", [dev])
        if dev.index is not None:
            return RankPlan("nccl" if local_world == 1 else "gloo", [dev])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return RankPlan("gloo", [])
    cards = [torch.device("cuda", i) for i in range(n)]
    if n >= local_world:
        per = n // local_world
        return RankPlan("nccl", cards[local_rank * per:(local_rank + 1) * per])
    return RankPlan("gloo", [cards[local_rank % n]])


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
    no-op. The backend and this process's current card come from
    :func:`rank_plan` (``device`` is the serving device the caller asked
    for, if any); every collective fails after :data:`DIST_TIMEOUT_S`
    instead of hanging.
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
    plan = rank_plan(world, rank, device)
    if plan.devices and plan.devices[0].type == "cuda":
        # the lead of this process's block: NCCL's communicator card and
        # the default of device=None
        torch.cuda.set_device(plan.devices[0])
    dist.init_process_group(backend=plan.backend,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S), **kwargs)
    log.info("process group up (%s): process %d/%d on %s", plan.backend, dist.get_rank(),
             dist.get_world_size(), [str(d) for d in plan.devices])
    return kwargs


def _own_cards(world: int, rank: int) -> list:
    """This process's default mesh devices: every visible card alone, its
    :func:`rank_plan` cards in a group (raises without a card)."""
    cards = _visible_devices()
    return cards if world == 1 else rank_plan(world, rank).devices


def pod_serving_mesh(slots: int = 1, devices: list | None = None) -> Mesh:
    """The ``"auto"`` serving mesh over the live topology: in a group of
    more than one process, hosts-major (``hosts`` = the world size, this
    process's hosts block the rank's, tenants over its devices); else flat
    tenants over this process's devices. ``devices`` are this process's
    (default: its :func:`rank_plan` cards; raises without a card)."""
    world, rank = _group()
    devs = _as_devices(devices) if devices is not None else _own_cards(world, rank)
    if slots < 1 or len(devs) % slots:
        raise ValueError(
            f"slots={slots} does not divide this process's {len(devs)} devices; "
            f"pick a slots axis that divides the per-process device count")
    if world > 1:
        return make_multihost_mesh(hosts=world, slots=slots, devices=devs, process=rank)
    return make_mesh(slots=slots, devices=devs)
