"""Fleet scheduler: inventory deltas -> batched solves -> splitter leafs
(the port of ``kcp_tpu.fleet.scheduler``).

The reconciler that closes the fleet loop. It does NOT replace the
DeploymentSplitter — it *drives* it: the splitter keeps its informers,
its leaf naming/labels/owner-refs, its status fan-in and its drain
machinery; this controller takes over only the placement *decision*
(``splitter.place = False``) and pushes solver assignments through
``splitter._apply_placement``.

Reconcile shape:

- Root Deployment events intern the root into a solver row (demand =
  spec.replicas, home region = the root's ``fleet.kcp.dev/region``
  label). Rows are never recycled; a deleted root zeroes out.
- Cluster events reach the shared :class:`ClusterInventory` through the
  splitter's existing handler; this controller just wakes up and asks
  ``inventory.delta_since(last_seen)`` which workspaces moved. Only
  roots in those workspaces re-solve — a Ready flap inside the
  hysteresis window bumps no version, so it re-solves NOTHING.
- Evacuation/readmission replans route here via ``splitter.replan_sink``
  (the splitter's delayed health check still makes the hysteresis call).
- One :class:`FleetSolver` dispatch covers every dirty row; the
  assignment diff against the previous solve feeds
  ``placement_churn_total`` (bounded-migration evidence), and every
  applied decision counts in ``placement_resolves_total``.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

from ..apis.cluster import REGION_LABEL
from ..reconciler.controller import BatchController
from ..reconcilers.deployment.controller import is_root
from ..utils.trace import REGISTRY
from .solver import DEFAULT_LOCALITY_WEIGHT, FleetSolver

log = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FleetScheduler:
    """Drives DeploymentSplitter leaf specs from FleetSolver decisions."""

    def __init__(self, splitter, spread: int | None = None,
                 locality_weight: int | None = None, solver=None, mesh=None):
        self.splitter = splitter
        self.inventory = splitter.inventory
        if spread is None:
            spread = _env_int("KCP_FLEET_SPREAD", 0)
        if locality_weight is None:
            locality_weight = _env_int("KCP_FLEET_LOCALITY_WEIGHT",
                                       DEFAULT_LOCALITY_WEIGHT)
        # the solve runs on the device of the splitter's fused lane (the
        # loop's FusedCore), or on the host with the host backend
        self.solver = solver or FleetSolver(
            spread=spread, locality_weight=locality_weight,
            backend=splitter.backend, mesh=mesh, device=splitter.device)
        # take over the placement decision; status fan-in stays put
        splitter.place = False
        splitter.replan_sink = self._on_replan
        # root interning: key -> row; parallel per-row arrays grown on use
        self._rows: dict[tuple[str, str, str], int] = {}
        self._row_keys: list[tuple[str, str, str]] = []
        self._demand = np.zeros(0, np.int32)
        self._home: list[str] = []
        self._ws_of: list[str] = []
        self._seen_version = 0
        self.controller = BatchController(
            "fleet-scheduler", self._process_batch,
            tenant_of=lambda item: item[1][0] if item[1] else "")
        splitter.informer.add_handler(self._on_deployment)
        splitter.cluster_informer.add_handler(self._on_cluster)
        self.stats = {"ticks": 0, "solves": 0, "applied": 0}

    # ------------------------------------------------------------ events

    def _on_deployment(self, etype: str, old: dict | None,
                       new: dict | None) -> None:
        obj = new or old
        if not is_root(obj):
            return
        m = obj["metadata"]
        key = (m.get("clusterName", ""), m.get("namespace", ""), m["name"])
        self.controller.enqueue(("root", key))

    def _on_cluster(self, etype: str, old: dict | None,
                    new: dict | None) -> None:
        # the splitter's handler (registered first) already folded this
        # event into the shared inventory; just schedule a delta sweep
        lc = (new or old)["metadata"].get("clusterName", "")
        self.controller.enqueue(("fleet", (lc,)))

    def _on_replan(self, lc: str,
                   rkeys: Sequence[tuple[str, str, str]]) -> None:
        """Evacuation/readmission sink from the splitter's health FSM."""
        for rkey in rkeys:
            self.controller.enqueue(("root", rkey))

    # -------------------------------------------------------------- tick

    def _row_for(self, key: tuple[str, str, str]) -> int:
        r = self._rows.get(key)
        if r is None:
            r = len(self._row_keys)
            self._rows[key] = r
            self._row_keys.append(key)
            self._demand = np.append(self._demand, np.int32(0))
            self._home.append("")
            self._ws_of.append(key[0])
        return r

    async def _process_batch(self, items: Sequence) -> list:
        self.stats["ticks"] += 1
        dirty: set[int] = set()
        for kind, key in items:
            if kind != "root":
                continue
            r = self._row_for(key)
            root = self.splitter.informer.cache.get(key)
            if root is None or not is_root(root):
                self._demand[r] = 0
            else:
                self._demand[r] = min(
                    int(root.get("spec", {}).get("replicas", 0) or 0), 65535)
                self._home[r] = ((root["metadata"].get("labels") or {})
                                 .get(REGION_LABEL, ""))
            dirty.add(r)
        ws_changed, self._seen_version = self.inventory.delta_since(
            self._seen_version)
        if ws_changed is None:
            dirty.update(range(len(self._row_keys)))
        elif ws_changed:
            dirty.update(r for r, ws in enumerate(self._ws_of)
                         if ws in ws_changed)
        if not dirty:
            return []
        view = self.inventory.view()
        W, P = len(self._row_keys), len(view.names)
        if P == 0:
            # no clusters registered at all: host-side status only
            return self._apply_rows(sorted(dirty), view,
                                    np.zeros((W, max(P, 1)), np.int32))
        cand = np.zeros((W, P), bool)
        home = np.zeros(W, np.int32)
        rid = {name: i for i, name in enumerate(view.regions)}
        for r in range(W):
            row = view.row_index.get(self._ws_of[r])
            if row is not None:
                cand[r] = view.candidates[row]
            # -1 matches no region id: an unlabeled root gets no bonus
            home[r] = rid.get(self._home[r], -1)
        try:
            counts = self.solver.solve(self._demand, cand, view.alloc,
                                       view.region_id, home,
                                       rows=sorted(dirty))
        except Exception as err:  # noqa: BLE001 — injected/solver failure
            log.warning("fleet-scheduler: solve failed (%s); %d rows "
                        "requeued, last good assignment stands", err,
                        len(dirty))
            return [(("root", self._row_keys[r]), err) for r in dirty]
        self.stats["solves"] += 1
        return self._apply_rows(sorted(dirty), view, counts)

    def _apply_rows(self, rows, view, counts) -> list:
        failed = []
        for r in rows:
            key = self._row_keys[r]
            root = self.splitter.informer.cache.get(key)
            if root is None or not is_root(root):
                continue
            lc = key[0]
            picked = [(view.names[p], int(counts[r, p]))
                      for p in np.nonzero(counts[r])[0]]
            picked.sort()
            if not picked and int(self._demand[r]) == 0:
                continue  # nothing to place; keep status honest
            clusters, ccounts = [], []
            for name, cnt in picked:
                obj = self.splitter.cluster_informer.get(lc, name)
                if obj is not None:
                    clusters.append(obj)
                    ccounts.append(cnt)
            leafs = self.splitter.informer.index("owned_by", "/".join(key))
            # forced: the splitter moves replicas between existing leafs
            # and drains de-selected ones even with `rebalance` off
            self.splitter._force_replan.add(key)
            try:
                self.splitter._apply_placement(
                    key, root, clusters, leafs,
                    np.asarray(ccounts, np.int32))
                self.stats["applied"] += 1
            except Exception as err:  # noqa: BLE001 — conflict etc: requeue
                failed.append((("root", key), err))
        return failed

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        # the splitter owns the informers and must already be started
        await self.controller.start()
        REGISTRY.gauge("fleet_scheduler_up",
                       "1 while the fleet scheduler is running").set(1)

    async def stop(self) -> None:
        await self.controller.stop()
        REGISTRY.gauge("fleet_scheduler_up",
                       "1 while the fleet scheduler is running").set(0)
