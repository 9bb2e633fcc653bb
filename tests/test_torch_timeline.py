"""The fused tick's timeline in ``obs.TRACER``, on the CPU.

A fleet ``FusedCore`` under a closed loop, with the tracer armed: one
trace per tick rooted at ``fused.tick``, a span for each stage of the
tick and of the device step, each child inside its parent, the step's
stages under ``step.dispatch``, and a collect made off the tick path (the
idle flush) parented onto the tick that submitted its wire. Armed, only
those ticks' spans skip the ring; the per-bucket path records the same
spans but the fleet batch's pack and upload. Disarmed, ticks are
head-sampled into the ring; with ``KCP_TRACE=0`` nothing is
recorded and no tick draws from the tracer's RNG. ``device_trace`` writes
the armed spans into its Chrome trace beside the profiler's events, on
the profiler's clock.
"""

import asyncio
import json
import os

import numpy as np
import pytest

from kcp_tpu_torch import obs
from kcp_tpu_torch.syncer.core import IDLE_FLUSH_S, FusedCore
from kcp_tpu_torch.utils.trace import REGISTRY, SPAN_TID, SPAN_TRACK, device_trace

S = 16
ROWS = 256
TICK_SPANS = {"fused.tick", "tick.drain", "tick.encode", "fleet.pack", "fleet.put",
              "step.dispatch"}
STEP_SPANS = {"step.stamps", "step.scatter", "step.decide_match", "step.splitter",
              "step.stats", "step.compact", "step.wire"}
COLLECT_SPANS = {"tick.collect", "tick.route_apply"}
#: spans recorded with microsecond-rounded bounds
EPS = 2e-6


class EchoOwner:
    """A section over ``ROWS`` rows that applies every patch and echoes it
    back as a downstream event, as a syncer's write returns through its
    informer."""

    def __init__(self, core):
        self.core = core
        self._mask = np.zeros(S, bool)
        self._mask[-2:] = True
        self.up = np.zeros((ROWS, S), np.uint32)
        self.down = np.zeros((ROWS, S), np.uint32)
        self.section = core.register(self, S)

    def fused_status_mask(self):
        return self._mask

    def fused_encode_many(self, keys):
        idx = np.fromiter(keys, np.int64, len(keys))
        ones = np.ones(idx.size, bool)
        return self.up[idx], ones, self.down[idx], ones

    def fused_apply(self, patches):
        rows = [int(k) for k, _c, _u in patches]
        self.down[rows] = self.up[rows]
        self.core.enqueue_many(self.section, True, rows)

    def fused_overflow(self):  # pragma: no cover - fixed vocabulary
        raise AssertionError("vocabulary never grows")


async def _until(cond, timeout: float = 20.0) -> bool:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            return False
        await asyncio.sleep(0.001)
    return True


async def _churn(core: FusedCore, owner: EchoOwner, steps: int, seed: int = 5) -> None:
    """``steps`` churns, each waited out until a tick took it, then quiet
    long enough for the idle flush to collect the last wires."""
    rng = np.random.default_rng(seed)
    fleet = core._fleet
    await core.start()
    try:
        for _ in range(steps):
            keys = rng.choice(ROWS, 8, replace=False)
            owner.up[keys] = rng.integers(1, 2**32, (8, S), dtype=np.uint32)
            before = fleet.stats["ticks"]
            core.enqueue_many(owner.section, False, keys.tolist())
            assert await _until(lambda: fleet.stats["ticks"] > before)
        await asyncio.sleep(20 * IDLE_FLUSH_S)
    finally:
        await core.stop()


def _core() -> tuple[FusedCore, EchoOwner]:
    core = FusedCore(device="cpu", fleet=True, pipeline="double", batch_window=0.0005)
    return core, EchoOwner(core)


@pytest.fixture
def tracer(monkeypatch):
    """``obs.TRACER`` reconfigured from the environment the test sets, and
    restored (disarmed, ring emptied) after it."""

    def configure(**env):
        for k in ("KCP_TRACE", "KCP_TRACE_SAMPLE", "KCP_TRACE_SEED", "KCP_TRACE_BUFFER"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        obs.TRACER.reconfigure()
        return obs.TRACER

    yield configure
    monkeypatch.undo()
    obs.TRACER.reconfigure()


def _armed_run(tracer, steps: int = 6) -> list[dict]:
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000")
    core, owner = _core()
    t.arm()
    try:
        asyncio.run(_churn(core, owner, steps))
    finally:
        spans = t.disarm()
    assert not t.armed and t.spans() == [], "armed spans leaked into the ring"
    return spans


def _by_trace(spans: list[dict]) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["trace"], []).append(s)
    return out


def _within(child: dict, parent: dict) -> bool:
    return (child["t0"] >= parent["t0"] - EPS
            and child["t0"] + child["dur"] <= parent["t0"] + parent["dur"] + EPS)


def test_an_armed_core_records_one_trace_per_tick_with_every_span(tracer):
    spans = _armed_run(tracer)
    traces = _by_trace(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert all(s["name"] == "fused.tick" for s in roots)
    assert sorted(s["trace"] for s in roots) == sorted(traces), "one root per trace"
    assert len(roots) >= 6
    assert {s["name"] for s in spans} == TICK_SPANS | STEP_SPANS | COLLECT_SPANS
    for tid, group in traces.items():
        names = [s["name"] for s in group]
        # a tick's own stages once each; a tick that submitted a step has
        # all of them, and every step stage once
        for name in TICK_SPANS | STEP_SPANS:
            assert names.count(name) <= 1, (name, names)
        if "step.dispatch" in names:
            assert TICK_SPANS | STEP_SPANS <= set(names), names
        assert "tick.drain" in names


def test_each_child_lies_within_its_parent_and_the_stages_within_the_step(tracer):
    spans = _armed_run(tracer)
    ids = {s["span"]: s for s in spans}
    assert len(ids) == len(spans), "span ids are unique"
    checked = 0
    for s in spans:
        if s["parent"] is None:
            continue
        parent = ids[s["parent"]]
        assert parent["trace"] == s["trace"]
        if s["name"] in STEP_SPANS:
            assert parent["name"] == "step.dispatch", s
        else:
            assert parent["name"] == "fused.tick", s
        if s["name"] in COLLECT_SPANS:
            continue  # a collect may run after its tick ended (next test)
        assert _within(s, parent), (s, parent)
        checked += 1
    assert checked > 6 * len(TICK_SPANS)


def test_an_idle_flush_collect_parents_onto_the_tick_that_submitted_its_wire(tracer):
    spans = _armed_run(tracer)
    ids = {s["span"]: s for s in spans}
    collects = [s for s in spans if s["name"] == "tick.collect"]
    assert collects
    for c in collects:
        root = ids[c["parent"]]
        assert root["name"] == "fused.tick" and root["trace"] == c["trace"]
        # the wire's step was submitted inside that tick, before the collect
        step = next(s for s in spans if s["trace"] == c["trace"] and s["name"] == "step.dispatch")
        assert c["t0"] >= step["t0"] + step["dur"] - EPS
    # the last wires wait for the idle flush, which runs after their tick
    late = [c for c in collects
            if c["t0"] > ids[c["parent"]]["t0"] + ids[c["parent"]]["dur"]]
    assert late, "no collect ran off the tick path"
    route = {(s["trace"], s["parent"]) for s in spans if s["name"] == "tick.route_apply"}
    assert {(c["trace"], c["parent"]) for c in collects} == route


def test_disarmed_ticks_are_head_sampled_into_the_ring(tracer):
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1")
    core, owner = _core()
    asyncio.run(_churn(core, owner, 4))
    ring = t.spans()
    assert {"fused.tick", "step.dispatch", "step.decide_match"} <= {s["name"] for s in ring}
    slowest = t.slowest(2)
    assert slowest and all(x["spans"] for x in slowest)
    # a coin that never says yes: no tick is traced
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000", KCP_TRACE_SEED="7")
    core, owner = _core()
    asyncio.run(_churn(core, owner, 4))
    assert [s for s in t.spans() if s["name"] == "fused.tick"] == []


class _NoDraws:
    """An RNG that fails the test if the tick loop draws from it."""

    def getrandbits(self, _k):
        raise AssertionError("a tick drew from the tracer's RNG with tracing off")


def test_tracing_off_records_nothing_and_draws_nothing(tracer):
    t = tracer(KCP_TRACE="0")
    t._rng = _NoDraws()
    drains = REGISTRY.histogram("fused_drain_seconds")
    n0 = drains.n
    core, owner = _core()
    t.arm()
    try:
        asyncio.run(_churn(core, owner, 4))
    finally:
        spans = t.disarm()
    assert spans == [] and t.spans() == []
    # the drain's one always-on histogram: one observation a tick
    assert drains.n - n0 == core.controller.ticks > 0


def test_an_armed_window_is_unbounded_and_returned_whole(tracer):
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000", KCP_TRACE_BUFFER="64")
    t.arm()
    root = t.tick_context()
    for i in range(5000):
        obs.record_span("fused.tick", t.child(root), root.span_id, float(i), 0.5)
    assert t.armed and t.spans() == []
    got = t.disarm()
    assert len(got) == 5000 and [s["t0"] for s in got] == [float(i) for i in range(5000)]
    assert t.disarm() == []
    # disarmed, a sampled span goes to the bounded ring again, that
    # tick's own too
    for i in range(100):
        obs.record_span("fused.tick", t.child(root), root.span_id, float(i), 0.5)
    assert len(t.spans()) == 64


def test_an_armed_window_leaves_every_other_span_in_the_ring(tracer):
    """Only the ticks traced while armed skip the ring: a span of any
    other trace recorded inside the window (a request's, a convergence
    phase) is still served from the ring."""
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000")
    other = t.mint(sampled=True)
    t.arm()
    tick = t.tick_context()
    obs.record_span("tick.encode", t.child(tick), tick.span_id, 1.0, 0.1)
    obs.record_span("conv.e2e", t.child(other), other.span_id, 1.0, 0.2)
    with obs.use(other):
        with obs.span("server.request"):
            pass
    assert [s["name"] for s in t.spans()] == ["conv.e2e", "server.request"]
    got = t.disarm()
    assert [s["name"] for s in got] == ["tick.encode"]
    assert {s["trace"] for s in t.spans()} == {other.trace_id}


def test_the_per_bucket_path_records_the_step_and_its_stages_but_no_fleet_spans(tracer):
    """Without the fleet batch each bucket submits its own step: the tick,
    its drain, encode, collect and routing, and the step with its seven
    stages under it; the pack and upload are the fleet batch's, not spanned
    here."""
    t = tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000")
    core = FusedCore(device="cpu", fleet=False, pipeline="double", batch_window=0.0005)
    owner = EchoOwner(core)
    t.arm()
    try:
        asyncio.run(_churn_buckets(core, owner, 4))
    finally:
        spans = t.disarm()
    names = {s["name"] for s in spans}
    assert names == (TICK_SPANS - {"fleet.pack", "fleet.put"}) | STEP_SPANS | COLLECT_SPANS
    ids = {s["span"]: s for s in spans}
    for s in spans:
        if s["name"] in STEP_SPANS:
            assert ids[s["parent"]]["name"] == "step.dispatch"
            assert _within(s, ids[s["parent"]]), s


async def _churn_buckets(core: FusedCore, owner: EchoOwner, steps: int) -> None:
    """:func:`_churn` for a core without the fleet batch: each churn is
    waited out until the tick loop took it."""
    rng = np.random.default_rng(11)
    await core.start()
    try:
        for _ in range(steps):
            keys = rng.choice(ROWS, 8, replace=False)
            owner.up[keys] = rng.integers(1, 2**32, (8, S), dtype=np.uint32)
            before = core.controller.ticks
            core.enqueue_many(owner.section, False, keys.tolist())
            assert await _until(lambda: core.controller.ticks > before)
        await asyncio.sleep(20 * IDLE_FLUSH_S)
    finally:
        await core.stop()


def test_device_trace_writes_the_armed_spans_beside_the_profiler_events(tracer, tmp_path):
    tracer(KCP_TRACE="1", KCP_TRACE_SAMPLE="1000000000")
    timings: dict = {}

    async def main():
        core, owner = _core()
        async with device_trace(str(tmp_path), timings) as started:
            assert started and obs.TRACER.armed
            await _churn(core, owner, 3)
        assert not obs.TRACER.armed

    asyncio.run(main())
    with open(os.path.join(tmp_path, "trace.json"), encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    track = [e for e in events if e.get("tid") == SPAN_TID and e.get("ph") == "X"]
    assert {"fused.tick", "step.dispatch", "step.decide_match"} <= {e["name"] for e in track}
    assert any(e.get("ph") == "M" and e.get("tid") == SPAN_TID
               and e["args"]["name"] == SPAN_TRACK for e in events)
    # the profiler's own CPU ops of a step's scatter lie inside that
    # step's span on the shared clock (1 us: the spans' rounding)
    steps = [e for e in track if e["name"] == "step.scatter"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("tid") != SPAN_TID
           and e.get("name") == "aten::index_put_"]
    assert steps and ops
    inside = [o for o in ops if any(s["ts"] - 1 <= o["ts"] and o["ts"] + o["dur"] <= s["ts"] + s["dur"] + 1
                                    for s in steps)]
    assert inside, "no scatter op inside a step.scatter span"
