"""Deterministic fault injection (``KCP_FAULTS``).

The north-star loop serves 10k logical clusters out of ONE fused device
program — at that blast radius "we handle failures" is not a claim that
can rest on production incidents. This module makes every failure mode a
*replayable input*: a ``KCP_FAULTS`` spec names injection points threaded
through the store, the REST client/watch relay, the syncer apply path and
the fused device step, and a seeded per-point PRNG makes any schedule
reproducible bit-for-bit (same spec + seed + call sequence = same faults).

Spec grammar — semicolon-separated clauses, each ``point:action``::

    KCP_FAULTS="store.put:error=0.05;watch:drop@tick=200;\
device.step:raise@tick=57;syncer.apply:latency=50ms"
    KCP_FAULTS_SEED=1337

    clause  := <point> ":" <action> [ "=" <value> ] { "@" <mod> "=" <mval> }
    action  := error | raise | drop | latency | poison_row
    value   := probability (0.05) | duration (50ms, 2s) | row index
    mod     := tick | peer | heal | jitter

- ``error``      raise :class:`~kcp_tpu.utils.errors.UnavailableError`
                 (an injected 503 — exercises retry/backoff/circuit paths)
- ``raise``      raise :class:`InjectedFault` (a non-API RuntimeError —
                 exercises the crash paths, e.g. a device-step failure)
- ``drop``       ask the site to drop its stream (watch connection loss)
- ``latency``    add ``value`` seconds of delay at the site
- ``poison_row`` fire whenever the site's ``rows`` metadata contains the
                 row index in ``value`` (a persistently-poisoned wire row
                 — what the FusedCore quarantine bisection hunts)

``@tick=N`` fires exactly on the Nth invocation of the point (1-based);
without it, ``value`` is a per-invocation probability (``error``/``drop``)
or always-on (``latency``/``poison_row``; ``raise`` with no value fires
every time).

WAN-link modifiers (the ``link.*`` points)::

    link.partition:drop@peer=*>10.0.0.2:6443@heal=40
    link.delay:latency=80ms@peer=repl.feed>replica@jitter=20ms

- ``@peer=SRC>DST`` scopes the rule to one *directed* link (``SRC<>DST``
  matches both directions; either side may be ``*``). A peer-scoped rule
  only fires at link-aware sites (:func:`link_fault`), so an asymmetric
  partition — A cannot reach B while B still reaches A — is one clause.
- ``@heal=N`` heals the rule at the point's Nth invocation: it fires on
  invocations 1..N-1 and never again (the heal-at-tick lever; the
  scenario engine's phase-end injector clear is the other heal path).
- ``@jitter=D`` adds a seeded uniform extra delay in [0, D] on top of a
  ``latency`` value — WAN jitter, reproducible per seed.

Injection points wired in this codebase:

    store.put / store.get / store.list / store.delete   store/store.py
    store.commit_window          store/store.py group-commit window flush
                                 (``drop`` = force a window split mid-
                                 fill; ``error``/``raise`` = the window's
                                 WAL sync fails — every writer parked on
                                 the window gets a typed 5xx and NONE of
                                 its records commit)
    watch                        store Watch + server/rest.py RestWatch
    watch.evict                  store/store.py Watch._push (``drop`` =
                                 force-evict the watcher as if its
                                 bounded queue overflowed: the stream
                                 ends with a terminal typed 410 and the
                                 informer relists — the backpressure
                                 drill)
    rest.request                 server/rest.py RestClient._request
    syncer.apply                 syncer/engine.py applier pool
    device.step                  syncer/core.py FusedBucket.submit/probe
    cluster.health               reconcilers/cluster pull-mode healthcheck
    admission.chain              admission/chain.py chain entry (writes)
    admission.quota              admission/quota.py post-reservation
                                 (an injected error exercises rollback)
    admission.flow               admission/flow.py FlowController.acquire
    encode.cache                 store/store.py encode-once byte cache
                                 (``drop`` discards a cached entry on
                                 lookup, forcing the re-encode fallback)
    router.proxy                 sharding/router.py router→shard relay
                                 (error = a shard relay answers 503,
                                 latency = a slow shard hop — the chaos
                                 lever for shard-death drills)
    repl.ship                    replication/hub.py WAL feed (error =
                                 the ship stream dies and the follower
                                 reconnects, latency = ship lag)
    repl.apply                   replication/applier.py record apply
                                 (error = the follower drops the feed
                                 and re-resumes from its applied RV)
    repl.promote                 replication/applier.py standby
                                 promotion (error = the promotion
                                 attempt aborts and retries after the
                                 next probe cycle)
    server.drain                 server/server.py graceful drain (error
                                 = the drain aborts and the shutdown
                                 escalates to an immediate hard stop,
                                 latency = a slow drain)
    scenario.phase               scenarios/engine.py phase boundary
                                 (latency = a stalled phase transition,
                                 error = the scenario run aborts — the
                                 harness's own failure path is drilled
                                 like everything else)
    migrate.cutover              sharding/migrate.py between migration
                                 finish and the ring flip — the worst
                                 instant to die (target loaded, ring not
                                 flipped; error = the migration aborts
                                 and the source fence rolls back so the
                                 cluster keeps serving from its old
                                 owner, latency = a slow cutover)
    link.partition               peer-pair link cut (``drop`` +
                                 ``@peer``): every link-aware transport
                                 — RestClient requests, RestWatch
                                 streams, the replication feed, the
                                 applier's probe/ack/fence calls —
                                 raises ConnectionError while the
                                 directed pair is cut
    link.delay                   peer-pair WAN latency (``latency`` +
                                 ``@peer`` [+ ``@jitter``]) at the same
                                 link-aware sites; sync sites sleep,
                                 async sites await
    fleet.solve                  fleet/solver.py device bin-pack entry
                                 (error = the solve fails and the
                                 scheduler retries with its last good
                                 assignment intact, latency = a slow
                                 solve tick)

Sites call the module-level helpers, which are near-free no-ops when no
injector is active (one global read).
"""

from __future__ import annotations

import logging
import os
import random
import threading
from dataclasses import dataclass, field

from .analysis.sanitize import make_lock
from .utils.errors import UnavailableError
from .utils.trace import REGISTRY

log = logging.getLogger(__name__)

ACTIONS = ("error", "raise", "drop", "latency", "poison_row")

#: The injection-point registry — the single spelling authority for every
#: point threaded through the codebase. ``scripts/lint.py``'s
#: fault-point-registry checker cross-references this set against every
#: ``maybe_fail``/``should_drop`` call site (a typo'd point silently
#: never fires) and against the ``point:action`` specs in tests (a point
#: no test exercises is a degraded-mode path with no drill). Add the
#: point here FIRST when wiring a new site.
POINTS = frozenset({
    "store.put",
    "store.get",
    "store.list",
    "store.delete",
    "store.commit_window",
    "watch",
    "watch.evict",
    "rest.request",
    "syncer.apply",
    "device.step",
    "cluster.health",
    "admission.chain",
    "admission.quota",
    "admission.flow",
    "encode.cache",
    "router.proxy",
    "repl.ship",
    "repl.apply",
    "repl.promote",
    "server.drain",
    "scenario.phase",
    "migrate.cutover",
    "link.partition",
    "link.delay",
    "fleet.solve",
})


class InjectedFault(RuntimeError):
    """A deliberately-injected non-API failure (``raise``/``poison_row``)."""


@dataclass
class FaultRule:
    point: str
    action: str
    value: float | None = None
    at_tick: int | None = None
    # link-scoped modifiers (``@peer=SRC>DST`` / ``@heal=N`` / ``@jitter=D``)
    peer: tuple[str, str, bool] | None = None  # (src, dst, bidirectional)
    heal: int | None = None
    jitter: float | None = None
    fired: int = 0

    def matches_peer(self, peer: tuple[str, str] | None) -> bool:
        """Does this rule apply to the (src, dst) directed pair? Rules
        without ``@peer`` fire everywhere; peer-scoped rules only fire at
        link-aware sites that supply the pair."""
        if self.peer is None:
            return True
        if peer is None:
            return False

        def one_way(src_pat: str, dst_pat: str) -> bool:
            return (src_pat in ("*", peer[0])
                    and dst_pat in ("*", peer[1]))

        src_pat, dst_pat, bidir = self.peer
        return one_way(src_pat, dst_pat) or (
            bidir and one_way(dst_pat, src_pat))


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
    """A parsed, seeded fault schedule; thread-safe (REST clients and the
    store-pool executor hit points off the serving loop)."""

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

    # ------------------------------------------------------------ firing

    def _advance(self, point: str, rows=None,
                 peer: tuple[str, str] | None = None
                 ) -> list[tuple[FaultRule, float]]:
        """Advance ``point``'s schedule; returns the fired (rule, delay)
        pairs. ``delay`` is the rule's latency value plus its seeded
        jitter sample (0.0 for non-latency actions)."""
        st = self._points.get(point)
        if st is None:
            return []
        with self._lock:
            st.count += 1
            fired: list[tuple[FaultRule, float]] = []
            for r in st.rules:
                if not r.matches_peer(peer):
                    continue
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
        """Advance ``point``'s schedule. Raises if an ``error`` (503) /
        ``raise`` / matching ``poison_row`` rule fires; returns the summed
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

    def should_drop(self, point: str) -> bool:
        """Advance ``point``'s schedule; True if a ``drop`` rule fired."""
        return any(r.action == "drop" for r, _ in self._advance(point))

    # ----------------------------------------------------- link realism

    def link_cut(self, point: str, src: str, dst: str) -> bool:
        """Advance a link point for the (src, dst) directed pair; True if
        a (possibly peer-scoped) ``drop`` rule cut the link."""
        return any(r.action == "drop"
                   for r, _ in self._advance(point, peer=(src, dst)))

    def link_delay(self, point: str, src: str, dst: str) -> float:
        """Summed latency+jitter seconds injected on the directed pair
        (0.0 when quiet). The caller sleeps — sync sites ``time.sleep``,
        async sites ``await asyncio.sleep``."""
        return sum(d for r, d in self._advance(point, peer=(src, dst))
                   if r.action == "latency")

    def snapshot(self) -> dict[str, int]:
        """point -> invocation count (replay/debugging aid)."""
        with self._lock:
            return {p: st.count for p, st in self._points.items()}


# --------------------------------------------------------------------------
# Process-global injector: KCP_FAULTS env (read once) or install()ed by
# tests / the chaos harness. Sites call the module helpers below.
# --------------------------------------------------------------------------

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


def should_drop(point: str) -> bool:
    inj = _ACTIVE if _ENV_CHECKED else active()
    return inj.should_drop(point) if inj is not None else False


def link_fault(src: str, dst: str) -> float:
    """One call per transport attempt on a directed link: raises
    :class:`ConnectionError` while an active ``link.partition`` rule cuts
    (src, dst); otherwise returns the ``link.delay`` seconds the caller
    must sleep (0.0 when no injector is active). ``dst`` is conventionally
    the target's ``host:port``; feed-side sources use stable role names
    (``repl.feed`` → subscriber role) so specs stay port-free."""
    inj = _ACTIVE if _ENV_CHECKED else active()
    if inj is None:
        return 0.0
    if inj.link_cut("link.partition", src, dst):
        raise ConnectionError(f"injected link partition: {src}>{dst}")
    return inj.link_delay("link.delay", src, dst)
