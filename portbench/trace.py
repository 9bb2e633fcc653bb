"""The reduction of a device trace to what the per-layer metrics read.

A run with ``--trace 1`` records the last part of its window with
``torch.profiler`` (``Profile``); :func:`reduce_events` works on plain
tuples ``(name, on_device, device_index, start_ns, duration_ns)`` so that
tests can hand it a synthetic profile. Busy time is the union of the device
intervals of each card (overlapping kernels count once), averaged over the
cards used."""

from __future__ import annotations

import re
from typing import NamedTuple

#: device activity that is a copy or a fill, not a kernel launch
NOT_LAUNCHES = ("Memcpy", "Memset")


class TraceReading(NamedTuple):
    window_s: float  # the traced window, by the host's clock
    busy_s: float  # union of device intervals, averaged over the cards
    ticks: int  # core ticks inside the traced window
    launches: int  # kernel events, every card
    ops: dict  # device op name -> (count, seconds)
    idle_gaps: list  # [(name, seconds)], longest first, at most 10


def short(name: str) -> str:
    """A device op's name without its namespace noise, template arguments
    and parameters."""
    n = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return (re.split(r"[<(]", n)[0].strip() or name)[:80]


def _union(intervals: list) -> tuple[float, list]:
    """(covered ns, gaps [(gap ns, name of the op after it)])."""
    intervals.sort()
    busy, gaps = 0, []
    end = None
    for start, stop, name in intervals:
        if end is None or start > end:
            if end is not None:
                gaps.append((start - end, name))
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy, gaps


def reduce_events(events, window_s: float, ticks: int, cards: int) -> TraceReading:
    per_card: dict[int, list] = {}
    ops: dict[str, list] = {}
    launches = 0
    for name, on_device, index, start, dur in events:
        if not on_device:
            continue
        name = short(name)
        per_card.setdefault(index, []).append((start, start + dur, name))
        tally = ops.setdefault(name, [0, 0.0])
        tally[0] += 1
        tally[1] += dur * 1e-9
        if not name.startswith(NOT_LAUNCHES):
            launches += 1
    busy, gaps = 0.0, []
    for index in sorted(per_card):
        covered, card_gaps = _union(per_card[index])
        busy += covered * 1e-9
        gaps += [(f"host_work_before_{name}", ns * 1e-9) for ns, name in card_gaps]
    gaps.sort(key=lambda g: -g[1])
    return TraceReading(window_s=window_s, busy_s=busy / max(cards, 1), ticks=ticks,
                        launches=launches, ops={k: tuple(v) for k, v in ops.items()},
                        idle_gaps=gaps[:10])


class Profile:
    """``torch.profiler`` over a part of the window, in three steps taken
    from the loop's callbacks: :meth:`prepare` (the profiler starts but
    keeps nothing, so its start-up cost stays out of the record),
    :meth:`record`, and :meth:`stop`."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile, schedule

        # the host's own activity only where there is no card (tests)
        what = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[what],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))

    def prepare(self) -> None:
        self._prof.start()

    def record(self) -> None:
        self._prof.step()

    def stop(self) -> None:
        self._prof.step()
        self._prof.stop()

    def events(self):
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            yield (e.name(), e.device_type() == DeviceType.CUDA, e.device_index(),
                   e.start_ns(), e.duration_ns())
