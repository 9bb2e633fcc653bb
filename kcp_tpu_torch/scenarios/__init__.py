"""Scenario harness: seeded end-to-end chaos scenarios with SLO
scorecards, the port's copy of the reference harness (the acceptance
harness for the sharded / replicated / fleet-batched stack).

- :mod:`.spec` — declarative scenario model (phases × tenant mixes ×
  fault schedules × SLOs);
- :mod:`.topology` — real-server constellations (monolith, shard fleet
  behind the router, primary+standby+replica);
- :mod:`.workload` — seeded replayable op schedules, writer ledgers,
  watch-stream observers with honest loss accounting;
- :mod:`.fleetload` — the fleet-churn and placement-study drivers;
- :mod:`.engine` — the run loop + scorecard; a scenario's device work
  (controllers, the engine-side solver) runs on its ``device``, the
  CUDA card unless the caller names another;
- :mod:`.catalog` — the named scenarios ``python -m
  kcp_tpu_torch.scenarios`` runs.
"""

from .catalog import SCENARIOS
from .engine import run_scenario
from .spec import SLO, Phase, ScenarioSpec

__all__ = ["SCENARIOS", "run_scenario", "SLO", "Phase", "ScenarioSpec"]
