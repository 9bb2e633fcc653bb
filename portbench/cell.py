"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, and the result line.

The window drives ``kcp_tpu_torch.syncer.core.FusedCore``, the served tick
loop, through ``register`` / ``enqueue_many`` / ``start`` / ``stop``, with
the harness's owner (``owner.py``) as its one section. After each tick the
owner churns the traffic's next rows: a closed loop. The warm-up ticks come
first and count as set-up; the window then runs ``--seconds``. A traced run
(``--trace 1``) reads the host's per-layer numbers over the first part of
its window, ``seconds - profile_seconds(seconds) - PREPARE_S``, then starts
the profiler, lets it settle for ``PREPARE_S`` once started, and records
``profile_seconds(seconds)``, the traced window."""

from __future__ import annotations

import asyncio
import gc
import subprocess
import time
import types

import numpy as np

from . import reference, spec
from .owner import CountLedger, HarnessOwner, Journal
from .trace import Profile, reduce_events
from .traffic import ChurnTraffic

#: the tick-phase histograms (``fused_<name>_seconds``) the readers use
PHASES = ("encode", "collect_wait", "pack", "put", "step_dispatch")
PREPARE_S = 0.5
STALL_S = 60.0


def profile_seconds(seconds: float) -> float:
    return min(3.0, 0.3 * seconds)


class Context(types.SimpleNamespace):
    """What the metric readers read (``portbench/metrics/<name>.py``)."""


def _phases(registry) -> dict:
    hists = {n: registry.histogram(f"fused_{n}_seconds") for n in PHASES}
    return {n: (h.total, h.n) for n, h in hists.items()}


class Window:
    """The closed loop's clock, run from the owner's per-tick callback."""

    def __init__(self, owner: HarnessOwner, seconds: float, warmup_ticks: int,
                 registry, profile: Profile | None, sync):
        self.owner, self.seconds, self.warmup_ticks = owner, seconds, warmup_ticks
        self.registry, self.profile, self.sync = registry, profile, sync
        self.done = asyncio.Event()
        self.t0 = self.t1 = self.host_end = self.start = None
        self.trace_t0 = self.trace_t1 = self.lat_cut = None
        # a traced run's host part ends here
        self.host_at = seconds - profile_seconds(seconds) - PREPARE_S
        self.gc_s, self._gc_t = 0.0, None
        self.error: BaseException | None = None

    def _gc(self, phase: str, _info) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def _end_host_part(self, now: float) -> None:
        gc.callbacks.remove(self._gc)
        o = self.owner
        self.host_end = {"t": now, "ticks": o.encodes, "changes": o.changes,
                         "phases": _phases(self.registry)}

    def on_tick(self) -> None:
        try:
            self._tick()
        except Exception as err:  # noqa: BLE001 — ends the run, raised by _drive
            self.error = err
            self.done.set()

    def _tick(self) -> None:
        o, now = self.owner, time.perf_counter()
        if self.t1 is not None:
            return
        if self.t0 is None:
            if o.encodes >= self.warmup_ticks:
                self.t0 = now
                self.start = {"ticks": o.encodes, "changes": o.changes,
                              "phases": _phases(self.registry)}
                gc.callbacks.append(self._gc)
        elif self.profile is None:
            if now - self.t0 >= self.seconds:
                self._close(now)
                return
        elif self.host_end is None:
            if self.lat_cut is None and now - self.t0 >= self.host_at - PREPARE_S:
                # the host part's latencies stop here, PREPARE_S before the
                # profiler's start-up stalls the loop
                self.lat_cut = o.changes
            if now - self.t0 >= self.host_at:
                self._end_host_part(now)
                self.profile.prepare()  # its start-up may take a while
                self.prepared = time.perf_counter()
        elif self.trace_t0 is None:
            if now - self.prepared >= PREPARE_S:
                self.profile.record()
                self.trace_t0, self.trace_ticks0 = time.perf_counter(), o.encodes
        elif now - self.trace_t0 >= profile_seconds(self.seconds):
            self._close(now)
            return
        o.churn()

    def _close(self, now: float) -> None:
        o = self.owner
        self.t1, self.ticks1, self.changes1 = now, o.encodes, o.changes
        if self.host_end is None:
            self._end_host_part(now)
        if self.profile is not None:
            self.sync()
            self.trace_t1, self.trace_ticks1 = time.perf_counter(), o.encodes
            self.profile.stop()
        self.done.set()


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"
    return "; ".join(out.splitlines())


async def _drive(cell: spec.Cell, traffic: ChurnTraffic, journal: Journal,
                 seconds: float, trace: bool, device) -> dict:
    import torch

    from kcp_tpu_torch.syncer.core import FusedCore
    from kcp_tpu_torch.utils.trace import REGISTRY

    cfg = cell.config
    core = FusedCore(batch_window=cfg["batch_window_s"], pipeline=cfg["pipeline"],
                     fleet=True, device=device)
    cards = [core.device] if core.device.type == "cuda" else []

    def sync() -> None:
        for d in cards:
            torch.cuda.synchronize(d)

    owner = HarnessOwner(core, traffic, cfg["patch_capacity"], journal)
    win = Window(owner, seconds, traffic.warmup_ticks, REGISTRY,
                 Profile(cuda=bool(cards)) if trace else None, sync)
    owner.loop, owner.on_tick = asyncio.get_running_loop(), win.on_tick
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    owner.churn()
    await core.start()
    seen, since = owner.encodes, time.perf_counter()
    while not win.done.is_set():
        try:
            await asyncio.wait_for(win.done.wait(), timeout=1.0)
        except asyncio.TimeoutError:
            if owner.encodes != seen:
                seen, since = owner.encodes, time.perf_counter()
            elif time.perf_counter() - since > STALL_S:
                raise RuntimeError(f"no tick for {STALL_S:.0f} s (stuck at tick "
                                   f"{seen})") from None
    await core.stop()
    if win.error is not None:
        raise win.error
    sync()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)
    return {"owner": owner, "win": win, "peak": peak, "n_cards": max(len(cards), 1),
            "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu"}


def _run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
         device) -> tuple[dict, ChurnTraffic, Journal]:
    from kcp_tpu_torch.syncer.core import FusedCore

    cfg = cell.config
    traffic = ChurnTraffic(cfg["rows"], cfg["objects"], cfg["slots"], cfg["status_slots"],
                           cell.traffic, seed)
    journal = Journal()
    FusedCore.set_process_ledger(CountLedger(journal))
    try:
        got = asyncio.run(_drive(cell, traffic, journal, seconds, trace, device))
    finally:
        FusedCore.set_process_ledger(None)
    # the program's state goes before the reference runs
    got["owner"].core = got["owner"].section = None
    return got, traffic, journal


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, control: bool = False) -> tuple[dict, list]:
    """The result line's object and the lines for standard error.
    ``device="cpu"`` (tests only) runs the core on the host, where the step
    takes the kernel's plain version. ``control`` (``control.py`` and the
    tests only) judges the control's patch sets in the program's place."""
    cfg = cell.config
    got, traffic, journal = _run(cell, seed, seconds, trace, device)
    owner, win = got["owner"], got["win"]
    t_ref = time.perf_counter()
    checks = reference.judge(journal, traffic, control)
    t_ref = time.perf_counter() - t_ref
    lat = owner.lat_s[win.start["changes"]:win.changes1]
    checks["lost_changes"] = int(np.isnan(lat).sum())

    host = win.host_end
    tr = None
    if trace:
        tr = reduce_events(win.profile.events(), win.trace_t1 - win.trace_t0,
                           win.trace_ticks1 - win.trace_ticks0, got["n_cards"])
    host_lat = owner.lat_s[win.start["changes"]:win.lat_cut or host["changes"]]
    ctx = Context(
        rows=cfg["rows"], objects=cfg["objects"], slots=cfg["slots"], kind=got["kind"],
        setup_s=win.t0 - t_start,
        ticks=win.ticks1 - win.start["ticks"], window_s=win.t1 - win.t0,
        latencies_ms=lat[~np.isnan(lat)] * 1e3,
        host_seconds=host["t"] - win.t0, host_ticks=host["ticks"] - win.start["ticks"],
        host_phases={n: (host["phases"][n][0] - win.start["phases"][n][0],
                         host["phases"][n][1] - win.start["phases"][n][1])
                     for n in PHASES},
        host_latencies_ms=host_lat[~np.isnan(host_lat)] * 1e3,
        gc_s=win.gc_s, trace=tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if got["kind"] != "cpu" else "cpu", "kind": got["kind"],
           "count": cell.chips, "memory_peak_bytes": int(got["peak"])}
    if got["kind"] != "cpu":
        dev["card"] = _card_line()
    result = {"correct": all(v == 0 for v in checks.values()),
              "attempted": int(lat.shape[0]), "failed": checks["lost_changes"],
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        top = sorted(tr.ops.items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {"device_ops": [[k, v[1]] for k, v in top],
                               "idle_gaps": [list(g) for g in tr.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    lines = [f"run: {ctx.ticks} ticks in {ctx.window_s:.3f} s, set-up {ctx.setup_s:.3f} s, "
             f"reference {t_ref:.3f} s"]
    lines += [f"check {k}: {v} (limit 0)" for k, v in checks.items()]
    return result, lines
