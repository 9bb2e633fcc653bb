"""Deterministic fault injection (``KCP_FAULTS``), the port's copy of the
parts of ``kcp_tpu.faults`` the serving core drives.

A ``KCP_FAULTS`` spec names injection points and a seeded per-point PRNG
makes any schedule reproducible (same spec + seed + call sequence = same
faults). The grammar is the reference's, so one spec drives both::

    KCP_FAULTS="device.step:raise@tick=57;device.step:poison_row=5"
    KCP_FAULTS_SEED=1337

    clause  := <point> ":" <action> [ "=" <value> ] { "@" <mod> "=" <mval> }
    action  := error | raise | drop | latency | poison_row
    value   := probability (0.05) | duration (50ms, 2s) | row index
    mod     := tick | peer | heal | jitter

- ``error``      raise :class:`~kcp_tpu_torch.utils.errors.UnavailableError`
- ``raise``      raise :class:`InjectedFault` (a device-step failure)
- ``drop``       ask the site to drop its stream
- ``latency``    return ``value`` seconds of delay to the site
- ``poison_row`` fire whenever the site's ``rows`` contain the row index
                 in ``value`` (what the FusedCore quarantine bisection
                 hunts)

``@tick=N`` fires exactly on the Nth invocation of the point (1-based);
``@heal=N`` stops a rule from the Nth invocation on; ``@jitter`` adds
seeded extra latency. ``@peer`` scopes a rule to a directed link; the
port has no link-aware site yet, so such rules parse and never fire.
This slice wires one point: ``device.step`` in ``syncer/core.py``
(``FusedBucket``/``FleetBatch`` submit and probe).
"""

from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass, field

from .utils.errors import UnavailableError
from .utils.locks import make_lock
from .utils.trace import REGISTRY

log = logging.getLogger(__name__)

ACTIONS = ("error", "raise", "drop", "latency", "poison_row")


class InjectedFault(RuntimeError):
    """A deliberately-injected non-API failure (``raise``/``poison_row``)."""


@dataclass
class FaultRule:
    point: str
    action: str
    value: float | None = None
    at_tick: int | None = None
    peer: tuple[str, str, bool] | None = None  # (src, dst, bidirectional)
    heal: int | None = None
    jitter: float | None = None
    fired: int = 0



def _parse_value(raw: str) -> float:
    if raw.endswith("ms"):
        return float(raw[:-2]) / 1000.0
    if raw.endswith("s"):
        return float(raw[:-1])
    return float(raw)


def parse_spec(spec: str) -> list[FaultRule]:
    rules: list[FaultRule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        point, _, rest = clause.partition(":")
        if not rest:
            raise ValueError(f"fault clause {clause!r} needs '<point>:<action>'")
        rest, *mods = rest.split("@")
        at_tick: int | None = None
        heal: int | None = None
        jitter: float | None = None
        peer: tuple[str, str, bool] | None = None
        for mod in mods:
            mkey, _, mval = mod.partition("=")
            if mkey == "tick":
                at_tick = int(mval)
            elif mkey == "heal":
                heal = int(mval)
            elif mkey == "jitter":
                jitter = _parse_value(mval)
            elif mkey == "peer":
                bidir = "<>" in mval
                src, _, dst = (mval.partition("<>") if bidir
                               else mval.partition(">"))
                if not src or not dst:
                    raise ValueError(
                        f"bad @peer={mval!r} in {clause!r}: want SRC>DST "
                        f"(directed) or SRC<>DST (both ways); '*' wildcards")
                peer = (src.strip(), dst.strip(), bidir)
            else:
                raise ValueError(f"unknown fault modifier {mod!r} in {clause!r}")
        action, _, raw = rest.partition("=")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} in {clause!r} "
                f"(one of {', '.join(ACTIONS)})")
        value = _parse_value(raw) if raw else None
        if jitter is not None and action != "latency":
            raise ValueError(
                f"@jitter only modifies latency rules, not {action!r} "
                f"in {clause!r}")
        rules.append(FaultRule(point.strip(), action, value, at_tick,
                               peer=peer, heal=heal, jitter=jitter))
    return rules


@dataclass
class _PointState:
    rules: list[FaultRule] = field(default_factory=list)
    count: int = 0
    rng: random.Random | None = None


class FaultInjector:
    """A parsed, seeded fault schedule; thread-safe."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._lock = make_lock("faults.injector")
        self._points: dict[str, _PointState] = {}
        for rule in parse_spec(spec):
            st = self._points.setdefault(rule.point, _PointState())
            st.rules.append(rule)
        for point, st in self._points.items():
            # per-point PRNG: a point's schedule depends only on its own
            # invocation sequence, never on interleaving with other points
            st.rng = random.Random(f"{seed}:{point}")

    def describe(self) -> str:
        return f"KCP_FAULTS={self.spec!r} seed={self.seed}"

    def _advance(self, point: str, rows=None) -> list[tuple[FaultRule, float]]:
        """Advance ``point``'s schedule; returns the fired (rule, delay)
        pairs (delay is 0.0 for non-latency actions)."""
        st = self._points.get(point)
        if st is None:
            return []
        with self._lock:
            st.count += 1
            fired: list[tuple[FaultRule, float]] = []
            for r in st.rules:
                if r.peer is not None:
                    continue  # link-scoped: fires only at link-aware sites (none here)
                if r.heal is not None and st.count >= r.heal:
                    continue  # healed: fires on invocations 1..heal-1
                if r.action == "poison_row":
                    if (rows is not None and r.value is not None
                            and int(r.value) in rows):
                        fired.append((r, 0.0))
                    continue
                if r.at_tick is not None:
                    if st.count == r.at_tick:
                        fired.append((r, 0.0))
                    continue
                if r.action == "latency":
                    delay = (r.value or 0.0) + (
                        st.rng.uniform(0.0, r.jitter) if r.jitter else 0.0)
                    fired.append((r, delay))
                    continue
                p = 1.0 if r.value is None else r.value
                if st.rng.random() < p:
                    fired.append((r, 0.0))
            for r, _ in fired:
                r.fired += 1
        for r, _ in fired:
            REGISTRY.counter(
                "fault_injected_total",
                "faults fired by the KCP_FAULTS injector").inc()
            REGISTRY.counter(
                f"fault_injected_{point.replace('.', '_')}_total",
                f"faults fired at the {point} injection point").inc()
            log.info("fault injected: %s:%s (invocation %d)",
                     point, r.action, st.count)
        return fired

    def maybe_fail(self, point: str, rows=None) -> float:
        """Advance ``point``'s schedule. Raises if an ``error`` / ``raise``
        / matching ``poison_row`` rule fires; returns the summed
        ``latency`` delay in seconds otherwise (0.0 when quiet)."""
        delay = 0.0
        for r, d in self._advance(point, rows):
            if r.action == "latency":
                delay += d
            elif r.action == "error":
                raise UnavailableError(f"injected fault: {point}:error")
            elif r.action == "raise":
                raise InjectedFault(f"injected fault: {point}:raise")
            elif r.action == "poison_row":
                raise InjectedFault(
                    f"injected fault: {point}:poison_row={int(r.value)}")
        return delay


# Process-global injector: KCP_FAULTS env (read once) or install()ed by
# tests. Sites call maybe_fail, a near-free no-op when nothing is active.

_ACTIVE: FaultInjector | None = None
_ENV_CHECKED = False


def active() -> FaultInjector | None:
    global _ACTIVE, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get("KCP_FAULTS", "")
        if spec:
            _ACTIVE = FaultInjector(
                spec, int(os.environ.get("KCP_FAULTS_SEED", "0")))
            log.warning("fault injection ACTIVE: %s", _ACTIVE.describe())
    return _ACTIVE


def install(inj: FaultInjector | None) -> None:
    """Activate an injector programmatically (tests, chaos harnesses)."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = inj
    _ENV_CHECKED = True


def clear() -> None:
    install(None)


def maybe_fail(point: str, rows=None) -> float:
    inj = _ACTIVE if _ENV_CHECKED else active()
    return inj.maybe_fail(point, rows) if inj is not None else 0.0
