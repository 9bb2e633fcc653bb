"""Scenario specs: declarative phases × tenant mixes × fault schedules
with declared SLOs.

A scenario is DATA, not code: the engine (engine.py) interprets the
same spec the scorecard reports, so what ran and what was asserted are
one artifact. Every run is seeded and replayable — the op schedule is
derived from the seed alone (workload.py), the fault schedule is a
``KCP_FAULTS`` spec string interpreted by the seeded injector, and the
scorecard carries a hash of both so "same seed ⇒ same schedule" is
checkable, not folklore.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

#: comparison operators an SLO may declare
SLO_OPS = ("<=", ">=", "==")


@dataclass(frozen=True)
class SLO:
    """One service-level objective: a named bound on a measurement the
    engine produces (``metric`` keys into the scenario's measurement
    dict; unknown metrics fail the scenario loudly — a typo'd SLO must
    never pass by vacuity)."""

    name: str
    metric: str
    op: str
    target: float

    def __post_init__(self):
        if self.op not in SLO_OPS:
            raise ValueError(f"SLO {self.name!r}: unknown op {self.op!r} "
                             f"(one of {SLO_OPS})")

    def check(self, observed: float) -> bool:
        if self.op == "<=":
            return observed <= self.target
        if self.op == ">=":
            return observed >= self.target
        return observed == self.target


@dataclass(frozen=True)
class Phase:
    """One scenario phase: a slice of the seeded workload, an optional
    fault schedule active for its duration, and an optional engine
    action (topology chaos, watcher storms) fired once the writers are
    under way."""

    name: str
    ops_per_tenant: int = 0
    faults: str = ""        # KCP_FAULTS spec installed for this phase;
    # {primary}/{standby}/{replica} template to the topology's
    # host:port for that role (WAN link faults are peer-pair-scoped)
    action: str = ""        # engine action: rolling_restart_drain |
    # rolling_restart_kill | kill_primary | drop_watchers | flood |
    # move_shard (drain a shard, restart on a NEW address, republish
    # /ring — the ring-change-under-load lever) | scale_out (grow the
    # fleet by one shard live and migrate every moving cluster's WAL
    # onto it — the elastic-capacity lever)
    settle_s: float = 0.3   # quiesce wait after the phase's work completes


@dataclass(frozen=True)
class ScenarioSpec:
    """A named, seeded, end-to-end scenario."""

    name: str
    description: str
    topology: str                      # monolith | fleet | replicated | none
    tenants: int
    phases: tuple[Phase, ...]
    slos: tuple[SLO, ...]
    workload: str = "configmaps"       # configmaps | crd | fleet | placement
    watchers_per_tenant: int = 1
    env: dict = field(default_factory=dict)       # server-process env
    options: dict = field(default_factory=dict)   # engine knobs
    topology_args: dict = field(default_factory=dict)

    def scaled(self, scale: float) -> "ScenarioSpec":
        """A reduced/enlarged copy for CI smokes vs full runs: tenant
        count and per-phase op counts scale (floored at useful minima);
        SLO targets do NOT scale — an objective that only holds at toy
        scale is not an objective."""
        if scale == 1.0:
            return self
        tenants = max(2, math.ceil(self.tenants * scale))
        watchers = (max(1, math.ceil(self.watchers_per_tenant * scale))
                    if self.watchers_per_tenant else 0)
        phases = tuple(
            dataclasses.replace(
                p, ops_per_tenant=(max(4, math.ceil(p.ops_per_tenant * scale))
                                   if p.ops_per_tenant else 0))
            for p in self.phases)
        options = dict(self.options)
        for k in ("flood_ops",):
            if k in options:
                options[k] = max(20, math.ceil(options[k] * scale))
        return dataclasses.replace(self, tenants=tenants,
                                   watchers_per_tenant=watchers,
                                   phases=phases, options=options)
