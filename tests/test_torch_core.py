"""The port's FusedCore against the JAX FusedCore, on the CPU.

Both cores serve the same open-loop owner under the same lockstep churn
schedule (one enqueued batch per tick, no feedback), the schedule of
``test_pipeline.py``; the patch streams must be byte-identical for each
pipeline mode and fleet setting. All outputs are integers: every
comparison is exact equality. The overflow retick, the acks lane, the
mask stamp and a ``device.step`` poison/quarantine drill of
``test_fused_core.py`` / ``test_faults.py`` run against the port too.
"""

import asyncio

import numpy as np
import pytest

from kcp_tpu import faults as jax_faults
from kcp_tpu.syncer.core import FusedCore as JaxFusedCore
from kcp_tpu_torch import faults as torch_faults
from kcp_tpu_torch.syncer import core as torch_core_mod
from kcp_tpu_torch.syncer.core import FusedCore as TorchFusedCore
from kcp_tpu_torch.utils.trace import REGISTRY as TORCH_REGISTRY

S = 16  # slot width (one shared bucket)


class RecordingOwner:
    """Open-loop SectionOwner: a fixed mirror pair, every patch recorded,
    NO feedback — so both cores see an identical staging schedule."""

    def __init__(self, core, b: int, s: int = S):
        self.core = core
        mask = np.zeros(s, bool)
        mask[-2:] = True
        self._mask = mask
        self.up_vals = np.zeros((b, s), np.uint32)
        self.down_vals = np.zeros((b, s), np.uint32)
        self.stream: list[tuple[int, int, bool]] = []
        self.section = core.register(self, s)

    def fused_status_mask(self) -> np.ndarray:
        return self._mask

    def fused_encode(self, key: int):
        return self.up_vals[key], True, self.down_vals[key], True

    def fused_encode_many(self, keys):
        idx = np.fromiter(keys, np.int64, len(keys))
        ones = np.ones(idx.size, bool)
        return self.up_vals[idx], ones, self.down_vals[idx], ones

    def fused_apply(self, patches) -> None:
        self.stream.extend((int(k), int(c), bool(u)) for k, c, u in patches)

    def fused_overflow(self) -> None:  # pragma: no cover - fixed vocab
        raise AssertionError("vocabulary never grows")


class ClosedLoopOwner(RecordingOwner):
    """Applies every patch (down <- up) and feeds the echo back as a
    down-side event, like a syncer whose downstream write comes back
    through its informer."""

    def fused_apply(self, patches) -> None:
        super().fused_apply(patches)
        rows = [int(k) for k, _c, _u in patches]
        self.down_vals[rows] = self.up_vals[rows]
        self.core.enqueue_many(self.section, True, rows)


def _make_core(impl: str, pallas: bool = False, mesh=None, **kw):
    """A reference core (optionally on its Pallas lane) or a port core;
    ``mesh`` is a mesh of that implementation (the port's over ``cpu``)."""
    if impl == "jax":
        return JaxFusedCore(use_pallas=pallas, mesh=mesh, **kw)
    if mesh is not None:
        return TorchFusedCore(mesh=mesh, **kw)
    return TorchFusedCore(device="cpu", **kw)


async def _until(cond, timeout: float = 20.0) -> bool:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            return False
        await asyncio.sleep(0.002)
    return True


def _stream_bytes(stream) -> bytes:
    return np.asarray([(k, c, int(u)) for k, c, u in stream], np.int64).tobytes()


async def _lockstep(impl: str, pipeline: str, fleet: bool, seed: int,
                    rows: int = 384, steps: int = 16,
                    pallas: bool = False, mesh=None) -> tuple[bytes, int]:
    core = _make_core(impl, pallas=pallas, mesh=mesh, batch_window=0.0005,
                      pipeline=pipeline, fleet=fleet)
    owner = RecordingOwner(core, rows)
    # a second section in its own (wider) bucket: fleet mode packs both
    # buckets into one ragged batch, per-bucket mode ticks them apart
    other = RecordingOwner(core, 32, s=2 * S)
    # count finished batches: a step's events go in only once every batch
    # the tick loop started has finished, so none of them can land in a
    # still-processing tick's redo set and split across ticks at a point
    # that depends on machine load. In-flight wires must be ready too:
    # the reference's CPU device_put can alias its staging buffer, which
    # a later tick repacks while an asynchronously dispatched step may
    # not have read it yet (ROADMAP queue C)
    ctl = core.controller
    inner, finished = ctl.process_batch, [0]

    async def counted(batch):
        try:
            return await inner(batch)
        finally:
            finished[0] += 1

    ctl.process_batch = counted
    await core.start()
    bucket = owner.section.bucket
    rng = np.random.default_rng(seed)
    # churn pool < MIN_PATCH_CAPACITY so level-triggered re-patches never
    # overflow (overflow reticks at mode-dependent times)
    pool = 200
    for step in range(steps):
        n = int(rng.integers(1, 32))
        touched = rng.choice(pool, size=n, replace=False)
        owner.up_vals[touched] = rng.integers(1, 2**32, (n, S), dtype=np.uint32)
        # the step's events go in as ONE queue batch: separate enqueues
        # could be split across ticks at timing-dependent points
        items = [(id(owner), False, int(k), owner.section) for k in touched]
        if step % 4 == 0:
            # status-only churn on the downstream side: upsync lane
            owner.down_vals[touched[:2], -1] ^= 5
            items += [(id(owner), True, int(k), owner.section) for k in touched[:2]]
        if step % 5 == 0:
            j = int(rng.integers(0, 32))
            other.up_vals[j] = rng.integers(1, 2**32, 2 * S, dtype=np.uint32)
            items.append((id(other), False, j, other.section))
        before = bucket.stats["ticks"]
        core.controller.enqueue_many(items)
        assert await _until(lambda: bucket.stats["ticks"] > before
                            and finished[0] == ctl.ticks
                            and all(w.is_ready() for _b, w, _m in core._inflight)), (
            f"{impl}/{pipeline}: tick never ran for step {step}")
    await core.stop()
    assert not core._inflight
    return (_stream_bytes(owner.stream) + b"|" + _stream_bytes(other.stream),
            bucket.stats["ticks"])


@pytest.mark.parametrize("fleet", [False, True], ids=["buckets", "fleet"])
@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("seed", [1, 9, 27])
def test_patch_streams_match_jax_core(seed, pipeline, fleet):
    """Byte-identical patch streams, port vs reference, per mode."""

    async def main():
        ref, ref_ticks = await _lockstep("jax", pipeline, fleet, seed)
        got, got_ticks = await _lockstep("torch", pipeline, fleet, seed)
        assert got_ticks == ref_ticks
        assert len(ref) > 1, "schedule produced no patches — vacuous"
        assert got == ref, f"seed={seed}: port stream diverged from the reference"

    asyncio.run(main())


def test_patch_overflow_reticks_until_converged():
    """More actionable rows than patch capacity: capacity doubles and the
    core reticks until every row converged (test_fused_core's case, with
    a closed-loop owner instead of a store-backed syncer)."""

    async def main():
        core = _make_core("torch", batch_window=0.0005)
        owner = ClosedLoopOwner(core, 128)
        bucket = owner.section.bucket
        bucket.patch_capacity = 16
        await core.start()
        rows = list(range(100))
        owner.up_vals[rows] = np.arange(1, 101, dtype=np.uint32)[:, None]
        core.enqueue_many(owner.section, False, rows)
        assert await _until(lambda: (owner.down_vals == owner.up_vals).all())
        assert bucket.stats["overflows"] >= 1
        assert bucket.patch_capacity > 16
        await core.stop()
        assert (owner.down_vals == owner.up_vals).all()

    asyncio.run(main())


def test_ack_lane_compresses_feedback_and_stays_correct():
    """The downstream echo of an applied sync rides the acks lane
    (stats['acked'] grows) and later churn still converges."""

    async def main():
        core = _make_core("torch", batch_window=0.0005)
        owner = ClosedLoopOwner(core, 64)
        bucket = owner.section.bucket
        await core.start()
        owner.up_vals[:16] = 3
        core.enqueue_many(owner.section, False, list(range(16)))
        assert await _until(lambda: bucket.stats["acked"] > 0)
        owner.up_vals[3] = 99
        core.enqueue(owner.section, False, 3)
        assert await _until(lambda: (owner.down_vals == owner.up_vals).all())
        await core.stop()

    asyncio.run(main())


def test_poison_row_quarantine_isolates_bad_row():
    """device.step poison drill: the poisoned submission fails, retries
    once, bisects and quarantines ONLY row 3; co-tenants converge; the
    key recovers once the fault lifts."""

    async def main():
        torch_faults.install(torch_faults.FaultInjector(
            "device.step:poison_row=3", seed=0))
        try:
            q0 = TORCH_REGISTRY.counter("quarantined_rows").value
            core = _make_core("torch", batch_window=0.0005, pipeline="double")
            owner = RecordingOwner(core, 64)
            bucket = owner.section.bucket
            await core.start()
            keys = list(range(30))
            owner.up_vals[keys, 0] = 7
            core.enqueue_many(owner.section, False, keys)
            assert await _until(lambda: bucket.stats["quarantined"] >= 1)
            assert await _until(
                lambda: {k for k, _c, _u in owner.stream} >= set(keys) - {3})
            assert 3 not in {k for k, _c, _u in owner.stream}
            assert TORCH_REGISTRY.counter("quarantined_rows").value >= q0 + 1
            assert bucket.stats["step_failures"] >= 2
            torch_faults.clear()
            assert await _until(lambda: 3 in {k for k, _c, _u in owner.stream})
            await core.stop()
        finally:
            torch_faults.clear()

    asyncio.run(main())


def test_faulted_schedule_matches_jax_core(monkeypatch):
    """The same seeded fault schedule (a transient raise plus a poisoned
    row) through both cores: byte-identical patch streams, so retry,
    bisection and quarantine behave as the reference's."""
    monkeypatch.setattr(torch_core_mod, "QUARANTINE_BASE_BACKOFF", 120.0)
    from kcp_tpu.syncer import core as jax_core_mod

    monkeypatch.setattr(jax_core_mod, "QUARANTINE_BASE_BACKOFF", 120.0)
    spec = "device.step:raise@tick=4;device.step:poison_row=3"

    async def run(impl):
        mod = jax_faults if impl == "jax" else torch_faults
        mod.install(mod.FaultInjector(spec, seed=99))
        try:
            core = _make_core(impl, batch_window=0.0005, pipeline="serial")
            owner = RecordingOwner(core, 256)
            bucket = owner.section.bucket
            await core.start()
            owner.up_vals[:8] = 1
            before = bucket.stats["ticks"]
            core.enqueue_many(owner.section, False, list(range(8)))
            assert await _until(lambda: bucket.stats["ticks"] > before)
            rng = np.random.default_rng(5)
            for _step in range(8):
                touched = rng.choice(100, size=int(rng.integers(1, 16)),
                                     replace=False)
                owner.up_vals[touched] = rng.integers(
                    1, 2**32, (touched.size, S), dtype=np.uint32)
                before = bucket.stats["ticks"]
                core.enqueue_many(owner.section, False, touched.tolist())
                assert await _until(lambda: bucket.stats["ticks"] > before)
            await core.stop()
            return _stream_bytes(owner.stream), bucket.stats["quarantined"]
        finally:
            mod.clear()

    async def main():
        ref, ref_q = await run("jax")
        got, got_q = await run("torch")
        assert ref_q >= 1 and got_q == ref_q
        assert got == ref

    asyncio.run(main())


def test_core_without_a_card_refuses_the_default_device():
    """device=None means the CUDA card; without one the core raises
    instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchFusedCore()
    # a mesh is a parallel.mesh.Mesh; anything else is refused
    with pytest.raises(TypeError, match="Mesh"):
        TorchFusedCore(mesh=object(), device="cpu")
