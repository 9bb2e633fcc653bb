"""Scenario harness: seeded end-to-end chaos scenarios with SLO
scorecards, the port's copy of ``kcp_tpu.scenarios``.

- :mod:`.topology` — real-server constellations (monolith, shard fleet
  behind the router, primary+standby+replica).

The scenario model, its engine and its catalog (``spec``, ``workload``,
``engine``, ``catalog``) are not ported yet: asking this package for
their names raises, naming ROADMAP A8.3.
"""

_NOT_PORTED = {"SCENARIOS", "run_scenario", "SLO", "Phase", "ScenarioSpec"}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"kcp_tpu_torch.scenarios.{name} needs the scenario spec, "
            f"engine and catalog, not ported yet (ROADMAP A8.3)")
    raise AttributeError(name)
