"""Multi-process bring-up: ``torch.distributed`` arguments and the
topology-derived serving mesh (the port of
``kcp_tpu.parallel.distributed``).

``init_distributed`` assembles the process-group arguments from explicit
args or the ``torch.distributed`` environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). An explicit single process is
a no-op. A world of more than one process would need a ``hosts`` axis
whose shards live in other processes; the port's mesh holds every shard
in this process, so that raises ``NotImplementedError`` (ROADMAP A7).
``pod_serving_mesh`` is the ``"auto"`` spec: a flat tenants mesh over
this process's visible CUDA devices.
"""

from __future__ import annotations

import logging
import os

from .mesh import Mesh, _visible_devices, make_mesh

log = logging.getLogger(__name__)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     _dry_run: bool = False) -> dict:
    """Assemble the process-group arguments; returns the kwargs used.

    Explicit args win; otherwise ``MASTER_ADDR``:``MASTER_PORT`` (as a
    ``tcp://`` init method), ``WORLD_SIZE`` and ``RANK``. ``_dry_run``
    only assembles (the argument tests). An explicit single process is a
    no-op; a larger world raises ``NotImplementedError``.
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
    raise NotImplementedError(
        "multi-process serving needs a hosts axis whose shards live in other "
        "processes; the port's mesh holds every shard in this process "
        "(ROADMAP A7). Serve one process per host, or pass num_processes=1")


def pod_serving_mesh(slots: int = 1) -> Mesh:
    """The ``"auto"`` serving mesh: flat tenants over this process's
    visible CUDA devices (raises without a card)."""
    devs = _visible_devices()
    if slots < 1 or len(devs) % slots:
        raise ValueError(
            f"slots={slots} does not divide the {len(devs)} visible devices; "
            f"pick a slots axis that divides the device count")
    return make_mesh(slots=slots, devices=devs)
