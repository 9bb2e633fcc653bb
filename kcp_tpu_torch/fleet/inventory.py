"""Fleet inventory: Cluster API objects -> versioned, device-shaped state.

The splitter and the fleet scheduler both need one answer to "which
physical clusters may receive replicas right now, and with what weight?".
:class:`ClusterInventory` is that single health/capacity authority:

- **Interned columns/rows.** Every pcluster name is interned to a stable
  column id, every workspace (logical cluster) to a stable row id, so the
  fleet's eligibility is a dense bool ``[W, P]`` matrix and its capacity
  a couple of ``[P]`` int vectors — exactly the shapes the device solver
  consumes, built incrementally instead of re-scanned per solve.
- **Hysteresis state machine per registration.** A Ready->NotReady flip
  starts a clock; only a flip that *holds* for ``evac_hysteresis``
  seconds evacuates the registration (mirroring the splitter semantics
  introduced with health-gated evacuation). A flap inside the window
  touches NO versioned state — zero placement churn by construction.
  The clock is injectable (``now=`` everywhere) so property tests drive
  10k workspaces through virtual time in milliseconds.
- **Versioned deltas.** Placement-relevant transitions (register/forget,
  evacuate/readmit, capacity or locality change) bump ``version`` and
  append to a journal; :meth:`delta_since` answers "which workspaces'
  candidate sets changed since version v?" so re-solves touch only those
  rows. The journal compacts; a consumer older than the floor gets
  ``None`` = resync everything.

Thread-model: informer handlers and controller ticks all run on the
asyncio loop thread, so the inventory is deliberately lock-free (same
discipline as the informer caches).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..apis import cluster as capi
from ..apis.conditions import FALSE, find_condition
from ..utils.trace import REGISTRY

DEFAULT_EVAC_HYSTERESIS = 5.0

# journal entries older than this many versions are compacted away;
# consumers further behind do one full resync (delta_since -> None)
_JOURNAL_KEEP = 4096


@dataclass
class ObservedDelta:
    """What one observe() changed — the caller's routing decisions."""

    notready_started: bool = False   # hysteresis clock armed: schedule a check
    recovered: bool = False          # NotReady cleared inside the window
    readmitted: bool = False         # evacuated registration turned Ready
    placement_changed: bool = False  # candidate set / weights moved (version bumped)


@dataclass(frozen=True)
class FleetView:
    """An immutable snapshot of the fleet at one version — the solver's
    input arrays. ``candidates[w, p]`` is registered-and-not-evacuated;
    capacity vectors are per *pcluster* (physical truth, shared across
    workspaces); ``region_id`` interns WAN locality labels."""

    version: int
    workspaces: tuple[str, ...]
    names: tuple[str, ...]
    regions: tuple[str, ...]
    candidates: np.ndarray   # bool  [W, P]
    capacity: np.ndarray     # int32 [P]
    alloc: np.ndarray        # int32 [P]
    region_id: np.ndarray    # int32 [P]
    row_index: dict[str, int] = field(hash=False, default_factory=dict)


def _explicitly_not_ready(obj: dict | None) -> bool:
    """Only a PRESENT Ready condition with status False counts — fresh
    registrations that never reported health stay placement-eligible."""
    if obj is None:
        return False
    c = find_condition(obj, capi.READY)
    return c is not None and c.get("status") == FALSE


class ClusterInventory:
    """Reconciles Cluster objects into versioned fleet placement state."""

    def __init__(self, evac_hysteresis: float = DEFAULT_EVAC_HYSTERESIS,
                 clock=time.monotonic):
        self.evac_hysteresis = evac_hysteresis
        self._clock = clock
        self._rows: dict[str, int] = {}
        self._cols: dict[str, int] = {}
        self._row_names: list[str] = []
        self._col_names: list[str] = []
        self._region_ids: dict[str, int] = {"": 0}
        self._region_names: list[str] = [""]
        self._registered = np.zeros((8, 8), dtype=bool)
        self._evacuated = np.zeros((8, 8), dtype=bool)
        self._capacity = np.zeros(8, dtype=np.int32)
        self._alloc = np.zeros(8, dtype=np.int32)
        self._region = np.zeros(8, dtype=np.int32)
        # armed hysteresis clocks: (row, col) -> monotonic start
        self._notready_since: dict[tuple[int, int], float] = {}
        self.version = 0
        self._journal: list[tuple[int, str, int]] = []  # (version, 'w'|'p', idx)
        self._journal_floor = 0
        self._view: FleetView | None = None

    # --------------------------------------------------------- interning

    def _row(self, workspace: str) -> int:
        w = self._rows.get(workspace)
        if w is None:
            w = len(self._row_names)
            self._rows[workspace] = w
            self._row_names.append(workspace)
            if w >= self._registered.shape[0]:
                grow = self._registered.shape[0]
                pad = ((0, grow), (0, 0))
                self._registered = np.pad(self._registered, pad)
                self._evacuated = np.pad(self._evacuated, pad)
        return w

    def _col(self, name: str) -> int:
        p = self._cols.get(name)
        if p is None:
            p = len(self._col_names)
            self._cols[name] = p
            self._col_names.append(name)
            if p >= self._registered.shape[1]:
                grow = self._registered.shape[1]
                self._registered = np.pad(self._registered, ((0, 0), (0, grow)))
                self._evacuated = np.pad(self._evacuated, ((0, 0), (0, grow)))
                self._capacity = np.pad(self._capacity, (0, grow))
                self._alloc = np.pad(self._alloc, (0, grow))
                self._region = np.pad(self._region, (0, grow))
            REGISTRY.gauge(
                "fleet_pclusters",
                "physical clusters known to the fleet inventory").set(
                len(self._col_names))
        return p

    def _region_id(self, region: str) -> int:
        rid = self._region_ids.get(region)
        if rid is None:
            rid = len(self._region_names)
            self._region_ids[region] = rid
            self._region_names.append(region)
        return rid

    def _bump(self, kind: str, idx: int) -> None:
        self.version += 1
        self._journal.append((self.version, kind, idx))
        self._view = None
        if len(self._journal) > 2 * _JOURNAL_KEEP:
            floor = self.version - _JOURNAL_KEEP
            self._journal = [e for e in self._journal if e[0] > floor]
            self._journal_floor = floor

    # ----------------------------------------------------------- observe

    def observe(self, workspace: str, obj: dict, etype: str = "MODIFIED",
                now: float | None = None) -> ObservedDelta:
        """Fold one Cluster event into the fleet state. Health flips ride
        the hysteresis FSM; only placement-relevant transitions bump the
        version (a flap inside the window is invisible to consumers)."""
        now = self._clock() if now is None else now
        name = obj["metadata"]["name"]
        w, p = self._row(workspace), self._col(name)
        d = ObservedDelta()
        if etype == "DELETED":
            if self._registered[w, p]:
                self._registered[w, p] = False
                self._bump("w", w)
                d.placement_changed = True
            self._evacuated[w, p] = False
            self._notready_since.pop((w, p), None)
            return d
        if not self._registered[w, p]:
            self._registered[w, p] = True
            self._bump("w", w)
            d.placement_changed = True
        cap = capi.capacity_of(obj)
        alloc = capi.allocatable_of(obj)
        rid = self._region_id(capi.region_of(obj))
        if (cap != self._capacity[p] or alloc != self._alloc[p]
                or rid != self._region[p]):
            self._capacity[p] = cap
            self._alloc[p] = alloc
            self._region[p] = rid
            self._bump("p", p)
            d.placement_changed = True
        if _explicitly_not_ready(obj):
            if (w, p) not in self._notready_since:
                self._notready_since[(w, p)] = now
                d.notready_started = True
        else:
            if self._notready_since.pop((w, p), None) is not None:
                d.recovered = True
            if self._evacuated[w, p]:
                self._evacuated[w, p] = False
                self._bump("w", w)
                d.readmitted = True
                d.placement_changed = True
                REGISTRY.counter(
                    "cluster_readmissions_total",
                    "evacuated clusters readmitted on Ready recovery").inc()
                self._evac_gauge()
        return d

    def check_evacuate(self, workspace: str, name: str,
                       now: float | None = None) -> bool:
        """The delayed hysteresis decision: evacuate IFF the registration
        is still NotReady a full window after the flip. Returns True only
        on the pending->evacuated transition (bumps the version)."""
        now = self._clock() if now is None else now
        w, p = self._rows.get(workspace), self._cols.get(name)
        if w is None or p is None:
            return False
        since = self._notready_since.get((w, p))
        if since is None or self._evacuated[w, p]:
            return False
        if now - since < self.evac_hysteresis - 1e-3:
            return False  # a newer flap rescheduled its own check
        self._evacuated[w, p] = True
        self._bump("w", w)
        REGISTRY.counter(
            "cluster_evacuations_total",
            "physical clusters drained after sustained NotReady").inc()
        self._evac_gauge()
        return True

    def tick(self, now: float | None = None) -> list[tuple[str, str]]:
        """Sweep every armed clock; evacuate the expired ones. Returns the
        (workspace, name) pairs evacuated this sweep — the standalone-
        scheduler / property-test harness (informer-driven consumers use
        per-flip delayed checks instead)."""
        now = self._clock() if now is None else now
        out = []
        for (w, p), since in list(self._notready_since.items()):
            ws, name = self._row_names[w], self._col_names[p]
            if self.check_evacuate(ws, name, now=now):
                out.append((ws, name))
        return out

    def _evac_gauge(self) -> None:
        REGISTRY.gauge(
            "fleet_evacuated_pclusters",
            "registrations currently evacuated (sustained NotReady)").set(
            int(self._evacuated.sum()))

    # ----------------------------------------------------------- queries

    def is_evacuated(self, workspace: str, name: str) -> bool:
        w, p = self._rows.get(workspace), self._cols.get(name)
        return w is not None and p is not None and bool(self._evacuated[w, p])

    @property
    def evacuated_pairs(self) -> frozenset[tuple[str, str]]:
        """(workspace, name) pairs currently evacuated — the splitter's
        legacy ``_evacuated`` surface."""
        ws, ps = np.nonzero(self._evacuated)
        return frozenset(
            (self._row_names[w], self._col_names[p]) for w, p in zip(ws, ps))

    def pending(self) -> int:
        """Armed hysteresis clocks (NotReady inside the window)."""
        return len(self._notready_since)

    def row_of(self, workspace: str) -> int | None:
        return self._rows.get(workspace)

    def view(self) -> FleetView:
        """Snapshot at the current version (cached until the next bump)."""
        if self._view is None or self._view.version != self.version:
            W, P = len(self._row_names), len(self._col_names)
            self._view = FleetView(
                version=self.version,
                workspaces=tuple(self._row_names),
                names=tuple(self._col_names),
                regions=tuple(self._region_names),
                candidates=(self._registered[:W, :P]
                            & ~self._evacuated[:W, :P]).copy(),
                capacity=self._capacity[:P].copy(),
                alloc=self._alloc[:P].copy(),
                region_id=self._region[:P].copy(),
                row_index=dict(self._rows),
            )
        return self._view

    def delta_since(self, version: int) -> tuple[set[str] | None, int]:
        """Workspaces whose candidate set / weights changed after
        ``version`` (None = journal compacted past it, resync all), plus
        the version the caller should remember."""
        if version < self._journal_floor:
            return None, self.version
        rows: set[int] = set()
        cols: set[int] = set()
        for ver, kind, idx in self._journal:
            if ver <= version:
                continue
            (rows if kind == "w" else cols).add(idx)
        if cols:
            P = len(self._col_names)
            col_idx = np.fromiter(cols, dtype=np.int64)
            col_idx = col_idx[col_idx < P]
            if col_idx.size:
                hit = self._registered[:len(self._row_names), :P][:, col_idx]
                rows.update(int(w) for w in np.nonzero(hit.any(axis=1))[0])
        return {self._row_names[w] for w in rows}, self.version
