"""The fused tick's timeline laid over a device trace: which program span
was open on the host while each card sat idle, and which span launched
each kernel.

The program records one trace per tick in ``kcp_tpu_torch.obs.TRACER``
(``fused.tick`` and its stages), stamped on the wall clock that
``torch.profiler`` stamps its events with. :func:`split_idle` takes the
profile's events as plain tuples ``(name, on_device, device_index,
start_ns, duration_ns, correlation_id)`` and the spans as the tracer's
records, so tests can hand it synthetic ones. At each moment of the
traced window the innermost open span (the one started last) holds the
host; a card's idle time, the window less the union of its op intervals,
goes to the span that held the host meanwhile, and a kernel's launch goes
to the span open when the host called the runtime for it (the runtime
event of the same correlation id).

One traced run of a cell, as ``python3 -m portbench --trace 1`` makes it,
with the tracer armed over the profiled window, and the split printed as a
table on standard error and as one JSON line on standard output::

    python3 -m portbench.timeline --workload fleet-1m.trickle64 --seed 1234 --seconds 51

``--arm 0`` makes the same run with the tracer left alone, the reading to
set an armed run's cost against; ``--spans FILE`` writes the window's
spans there, one JSON object a line. No run of the benchmark runs this.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import NamedTuple

from .trace import NOT_LAUNCHES, Profile, short

#: the label of host time in which no span is open
UNSPANNED = "(no span)"
#: the spans that make up the device step's launch
STEP = "step.dispatch"


class TimelineSplit(NamedTuple):
    window_s: float  # the traced window, wall clock
    ticks: int  # fused.tick roots that started inside the window
    host_s: dict  # label -> seconds the label held the host
    idle_s: dict  # label -> idle device seconds while it did, averaged over the cards
    launches: dict  # label -> kernel launches it issued, every card
    unmatched_launches: int  # kernels with no runtime event of their correlation id
    gaps: list  # [(label, seconds)]: the ten longest idle gaps, longest first
    self_s: dict  # span name -> duration less its children's, summed

    def per_tick_ms(self, seconds: float) -> float | None:
        return seconds / self.ticks * 1e3 if self.ticks else None


def host_segments(spans: list[dict], w0: int, w1: int) -> list[tuple[int, int, str]]:
    """[w0, w1) (ns) cut into ``(start, end, label)`` pieces: the label is
    the name of the innermost open span (latest start; of two started at
    once, the shorter), or :data:`UNSPANNED`."""
    marks = []
    for i, s in enumerate(spans):
        a = max(int(round(s["t0"] * 1e9)), w0)
        b = min(int(round((s["t0"] + s["dur"]) * 1e9)), w1)
        if a < b:
            marks.append((a, 1, i))
            marks.append((b, 0, i))
    marks.sort()
    open_: dict[int, tuple] = {}
    out: list[tuple[int, int, str]] = []
    at = w0
    for t, opening, i in marks:
        if t > at:
            label = UNSPANNED
            if open_:
                label = spans[max(open_, key=open_.get)]["name"]
            if out and out[-1][2] == label and out[-1][1] == at:
                out[-1] = (out[-1][0], t, label)
            else:
                out.append((at, t, label))
            at = t
        if opening:
            s = spans[i]
            open_[i] = (s["t0"], -s["dur"])
        else:
            open_.pop(i, None)
    if at < w1:
        out.append((at, w1, UNSPANNED))
    return out


def _idle(intervals: list, w0: int, w1: int) -> list[tuple[int, int]]:
    """The gaps of [w0, w1) that ``intervals`` (start, end) leave."""
    gaps, at = [], w0
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, w1)))
        at = max(at, b)
        if at >= w1:
            break
    if at < w1:
        gaps.append((at, w1))
    return [(a, b) for a, b in gaps if b > a]


def _overlaps(segments: list, starts: list, a: int, b: int):
    """(label, ns) of each host segment that [a, b) overlaps."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(segments) and segments[i][0] < b:
        s0, s1, label = segments[i]
        ns = min(b, s1) - max(a, s0)
        if ns > 0:
            yield label, ns
        i += 1


def self_times(spans: list[dict]) -> dict:
    """Span name -> the summed durations of its spans, less the part of
    each that its own children cover."""
    kids: dict[str, list] = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append(s)
    out: dict[str, float] = {}
    for s in spans:
        covered, end = 0.0, s["t0"]
        t1 = s["t0"] + s["dur"]
        for c in sorted(kids.get(s["span"], ()), key=lambda c: c["t0"]):
            a, b = max(c["t0"], end), min(c["t0"] + c["dur"], t1)
            if b > a:
                covered += b - a
                end = b
        out[s["name"]] = out.get(s["name"], 0.0) + max(s["dur"] - covered, 0.0)
    return out


def split_idle(events, spans: list[dict], w0_ns: int, w1_ns: int,
               cards: int) -> TimelineSplit:
    """The window [w0_ns, w1_ns) of a profile (``events``) and of the
    tracer's spans, split by the innermost open span (module docstring)."""
    inside = [s for s in spans
              if s["t0"] * 1e9 < w1_ns and (s["t0"] + s["dur"]) * 1e9 > w0_ns]
    segments = host_segments(inside, w0_ns, w1_ns)
    starts = [seg[0] for seg in segments]
    host: dict[str, float] = {}
    for a, b, label in segments:
        host[label] = host.get(label, 0.0) + (b - a) * 1e-9

    busy: dict[int, list] = {}
    launched_at: dict[int, int] = {}
    kernels = []
    for name, on_device, index, start, dur, corr in events:
        if not on_device:
            if corr:
                launched_at[corr] = start
            continue
        busy.setdefault(index, []).append((start, start + dur))
        if not short(name).startswith(NOT_LAUNCHES) and w0_ns <= start < w1_ns:
            kernels.append(corr)

    idle: dict[str, float] = {}
    gaps = []
    for index in sorted(busy):
        for a, b in _idle(busy[index], w0_ns, w1_ns):
            parts: dict[str, int] = {}
            for label, ns in _overlaps(segments, starts, a, b):
                parts[label] = parts.get(label, 0) + ns
                idle[label] = idle.get(label, 0.0) + ns * 1e-9 / max(cards, 1)
            gaps.append((max(parts, key=parts.get) if parts else UNSPANNED, (b - a) * 1e-9))
    gaps.sort(key=lambda g: -g[1])

    launches: dict[str, int] = {}
    unmatched = 0
    for corr in kernels:
        at = launched_at.get(corr) if corr else None
        if at is None:
            unmatched += 1
        elif w0_ns <= at < w1_ns:  # else launched before the window opened
            label = segments[bisect.bisect_right(starts, at) - 1][2]
            launches[label] = launches.get(label, 0) + 1

    ticks = sum(1 for s in inside if s["name"] == "fused.tick" and s["t0"] * 1e9 >= w0_ns)
    return TimelineSplit(window_s=(w1_ns - w0_ns) * 1e-9, ticks=ticks, host_s=host,
                         idle_s=idle, launches=launches, unmatched_launches=unmatched,
                         gaps=gaps[:10], self_s=self_times(inside))


def readings(split: TimelineSplit) -> dict:
    """The two device-trace readings the split gives, ms a tick:
    ``idle_in_step_ms_per_tick`` (idle while ``step.dispatch`` or one of
    its stages held the host) and ``idle_unattributed_ms_per_tick`` (idle
    while no span was open)."""
    step = sum(v for k, v in split.idle_s.items() if k == STEP or k.startswith("step."))
    return {"idle_in_step_ms_per_tick": split.per_tick_ms(step),
            "idle_unattributed_ms_per_tick": split.per_tick_ms(split.idle_s.get(UNSPANNED, 0.0))}


def table(split: TimelineSplit) -> list[str]:
    """The split as lines: each label's host ms, device-idle ms and kernel
    launches a tick, the sum, and the ten longest idle gaps."""
    t = max(split.ticks, 1)
    labels = sorted(set(split.host_s) | set(split.idle_s) | set(split.launches),
                    key=lambda k: -split.host_s.get(k, 0.0))
    out = [f"timeline: {split.ticks} ticks in {split.window_s:.6f} s "
           f"({split.window_s / t * 1e3:.6f} ms a tick)",
           f"{'span':<20} {'host ms/tick':>14} {'idle ms/tick':>14} {'launches/tick':>14}"]
    for k in labels:
        out.append(f"{k:<20} {split.host_s.get(k, 0.0) / t * 1e3:>14.6f} "
                   f"{split.idle_s.get(k, 0.0) / t * 1e3:>14.6f} "
                   f"{split.launches.get(k, 0) / t:>14.3f}")
    out.append(f"{'sum':<20} {sum(split.host_s.values()) / t * 1e3:>14.6f} "
               f"{sum(split.idle_s.values()) / t * 1e3:>14.6f} "
               f"{sum(split.launches.values()) / t:>14.3f}")
    if split.unmatched_launches:
        out.append(f"kernels without a runtime event of their correlation id: "
                   f"{split.unmatched_launches / t:.3f} a tick")
    out.append("longest idle gaps: " + ", ".join(f"{k} {s * 1e3:.6f} ms" for k, s in split.gaps))
    return out


#: the histograms :class:`TimelineProfile` reads, ``fused_<name>_seconds``
HISTOGRAMS = ("drain", "dispatch")


def _counts() -> dict:
    """Fleet ticks and the totals of :data:`HISTOGRAMS`, as they stand."""
    from kcp_tpu_torch.utils.trace import REGISTRY

    out = {n: REGISTRY.histogram(f"fused_{n}_seconds").total for n in HISTOGRAMS}
    out["ticks"] = REGISTRY.counter("fused_fleet_ticks_total").value
    return out


class TimelineProfile(Profile):
    """:class:`Profile` with ``obs.TRACER`` armed over its recorded part
    (``arm=False`` leaves the tracer alone), the wall-clock bounds of that
    part, the profile's events with their correlation ids, and the
    :data:`HISTOGRAMS`' ms a tick over the run before the profiler starts
    (``host_ms``: the host part of the window, with the warm-up) and over
    the recorded part (``traced_ms``)."""

    def __init__(self, cuda: bool = True, arm: bool = True):
        super().__init__(cuda)
        self.arm = arm
        self.w0_ns = self.w1_ns = None
        self.spans: list[dict] = []
        self._marks = [_counts()]
        self.host_ms = self.traced_ms = None
        self.fleet_ticks = 0

    @staticmethod
    def _per_tick_ms(a: dict, b: dict) -> dict:
        ticks = b["ticks"] - a["ticks"]
        return {n: (b[n] - a[n]) / ticks * 1e3 if ticks else None for n in HISTOGRAMS}

    def prepare(self) -> None:
        self._marks.append(_counts())
        self.host_ms = self._per_tick_ms(*self._marks)
        super().prepare()

    def record(self) -> None:
        from kcp_tpu_torch.obs import TRACER

        super().record()
        if self.arm:
            TRACER.arm()
        self._marks.append(_counts())
        self.w0_ns = time.time_ns()

    def stop(self) -> None:
        from kcp_tpu_torch.obs import TRACER

        self.w1_ns = time.time_ns()
        end = _counts()
        self.traced_ms = self._per_tick_ms(self._marks[-1], end)
        self.fleet_ticks = end["ticks"] - self._marks[-1]["ticks"]
        if self.arm:
            self.spans = TRACER.disarm()
        super().stop()

    def correlated_events(self):
        """:meth:`Profile.events`' tuples with each event's correlation id
        (0 where the profiler gives none) last."""
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            yield (e.name(), e.device_type() == DeviceType.CUDA, e.device_index(),
                   e.start_ns(), e.duration_ns(), e.correlation_id())


def traced_run(cell, seed: int, seconds: float, arm: bool = True, device=None):
    """One traced run of ``cell`` (``cell.run_cell`` with ``trace=True``)
    whose profiler is a :class:`TimelineProfile`: (result, lines, the
    profile). Nothing else of the run differs from the benchmark's."""
    from . import cell as cell_mod

    made: list[TimelineProfile] = []

    class Recording(TimelineProfile):
        def __init__(self, cuda: bool = True):
            super().__init__(cuda, arm)
            made.append(self)

    saved = cell_mod.Profile
    cell_mod.Profile = Recording
    try:
        result, lines = cell_mod.run_cell(cell, seed, seconds, True, time.perf_counter(),
                                          device=device)
    finally:
        cell_mod.Profile = saved
    return result, lines, made[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--arm", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", help="write the window's spans to this file")
    args = ap.parse_args(argv)

    from . import spec
    from .__main__ import cache_env

    cell = spec.load_cell(args.workload)
    cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench.timeline: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    result, lines, prof = traced_run(cell, args.seed, args.seconds, bool(args.arm))
    out = {"workload": args.workload, "seed": args.seed, "arm": args.arm,
           "correct": result["correct"], "device": result["device"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "traced_window_s": (prof.w1_ns - prof.w0_ns) * 1e-9,
           "traced_ticks": prof.fleet_ticks,
           "histograms_ms_per_tick": {"host": prof.host_ms, "traced": prof.traced_ms}}
    if args.arm:
        split = split_idle(prof.correlated_events(), prof.spans, prof.w0_ns, prof.w1_ns,
                           cell.chips)
        lines += table(split)
        out.update(readings(split), ticks=split.ticks, spans=len(prof.spans),
                   host_ms=_ms(split.host_s, split.ticks), idle_ms=_ms(split.idle_s, split.ticks),
                   launches={k: v / max(split.ticks, 1) for k, v in split.launches.items()},
                   self_ms=_ms(split.self_s, split.ticks),
                   unmatched_launches=split.unmatched_launches, gaps=split.gaps)
    if args.spans:
        with open(args.spans, "w", encoding="utf-8") as f:
            f.writelines(json.dumps(s) + "\n" for s in prof.spans)
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(out))
    return 0


def _ms(seconds: dict, ticks: int) -> dict:
    return {k: v / max(ticks, 1) * 1e3 for k, v in seconds.items()}


if __name__ == "__main__":
    sys.exit(main())
