"""The timeline split (``timeline.py``) on a fixed synthetic profile with
synthetic spans, and one traced run of a tiny cell on the CPU."""

import pytest

from portbench import spec
from portbench import cell as cell_mod
from portbench.timeline import (
    UNSPANNED,
    host_segments,
    readings,
    self_times,
    split_idle,
    table,
    traced_run,
)

MS = 1_000_000  # ns
W0 = 1000 * 10**9  # the window opens here, ns on the wall clock


def _span(name, span, parent, t0_ms, dur_ms, trace="t1"):
    return {"trace": trace, "span": span, "parent": parent, "name": name,
            "t0": (W0 + t0_ms * MS) / 1e9, "dur": dur_ms * MS / 1e9}


def _spans():
    # two ticks of 10 ms in a 20 ms window: drain 0-3, step 3-8 with its
    # stages, a collect of the first tick's wire inside the second drain
    return [
        _span("fused.tick", "a", None, 0, 9),
        _span("tick.drain", "a1", "a", 0, 3),
        _span("step.dispatch", "a2", "a", 3, 5),
        _span("step.scatter", "a3", "a2", 4, 1),
        _span("step.decide_match", "a4", "a2", 5, 2),
        _span("fused.tick", "b", None, 10, 9, trace="t2"),
        _span("tick.drain", "b1", "b", 10, 4, trace="t2"),
        _span("tick.collect", "a5", "a", 11, 1),
        _span("step.dispatch", "b2", "b", 14, 4, trace="t2"),
    ]


def _events():
    # (name, on_device, card, start ns, duration ns, correlation id): the
    # card runs 3.5-4.5, 5.5-6.5 (launched at 5.2 inside decide_match) and
    # 15-16 ms; a copy at 9.5 ms; runtime calls on the host
    at = lambda ms: W0 + int(ms * MS)  # noqa: E731
    return [
        ("void at::native::index_put_kernel<...>(...)", True, 0, at(3.5), MS, 11),
        ("cudaLaunchKernel", False, 0, at(4.1), 10_000, 11),
        ("(anonymous namespace)::decide_match_kernel(Args)", True, 0, at(5.5), MS, 12),
        ("cudaLaunchKernel", False, 0, at(5.2), 10_000, 12),
        ("Memcpy HtoD (Pinned -> Device)", True, 0, at(9.5), MS // 2, 13),
        ("cudaMemcpyAsync", False, 0, at(9.0), 10_000, 13),
        ("void at::native::reduce_kernel<512, 1>(...)", True, 0, at(15), MS, 14),
        ("cudaLaunchKernel", False, 0, at(14.5), 10_000, 14),
        ("void at::native::elementwise_kernel<...>(...)", True, 0, at(16.5), MS // 2, 99),
    ]


def test_the_host_is_cut_by_the_innermost_open_span():
    segs = host_segments(_spans(), W0, W0 + 20 * MS)
    assert segs[0] == (W0, W0 + 3 * MS, "tick.drain")
    assert (W0 + 4 * MS, W0 + 5 * MS, "step.scatter") in segs
    assert (W0 + 9 * MS, W0 + 10 * MS, UNSPANNED) in segs
    # the collect started last: it holds the host inside the second drain
    assert (W0 + 11 * MS, W0 + 12 * MS, "tick.collect") in segs
    assert segs[-1] == (W0 + 19 * MS, W0 + 20 * MS, UNSPANNED)
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:])), "contiguous"


def test_idle_time_launches_and_gaps_go_to_the_span_open_on_the_host():
    s = split_idle(_events(), _spans(), W0, W0 + 20 * MS, cards=1)
    assert s.ticks == 2 and s.window_s == pytest.approx(0.020)
    assert sum(s.host_s.values()) == pytest.approx(0.020)
    assert s.host_s[UNSPANNED] == pytest.approx(0.002)  # 9-10, 19-20 ms
    assert s.host_s["step.dispatch"] == pytest.approx(0.006)  # 3-4, 7-8, 14-18 ms
    # busy 3.5-4.5, 5.5-6.5, 9.5-10, 15-16 and 16.5-17 ms: 4 ms of 20
    assert sum(s.idle_s.values()) == pytest.approx(0.016)
    assert s.idle_s == pytest.approx({
        "tick.drain": 0.006, "tick.collect": 0.001, "step.dispatch": 0.004,
        "step.scatter": 0.0005, "step.decide_match": 0.001, "fused.tick": 0.002,
        UNSPANNED: 0.0015})
    # by the runtime call of each kernel's correlation id, not its start
    assert s.launches == {"step.scatter": 1, "step.decide_match": 1, "step.dispatch": 1}
    assert s.unmatched_launches == 1  # correlation id 99 has no runtime event
    assert s.gaps[:2] == [("tick.drain", pytest.approx(0.005)),  # 10-15 ms
                          ("tick.drain", pytest.approx(0.0035))]  # 0-3.5 ms
    r = readings(s)
    assert r["idle_in_step_ms_per_tick"] == pytest.approx((4 + 0.5 + 1) / 2)
    assert r["idle_unattributed_ms_per_tick"] == pytest.approx(0.75)
    lines = table(s)
    assert lines[0].startswith("timeline: 2 ticks")
    assert any(line.startswith("sum ") for line in lines)


def test_self_times_leave_out_the_children():
    got = self_times(_spans())
    assert got["step.dispatch"] == pytest.approx(0.006)
    # the late collect lies outside its tick: it takes nothing off it
    assert got["fused.tick"] == pytest.approx(0.002)


def test_nothing_to_split_reads_nothing():
    s = split_idle([], [], W0, W0 + 20 * MS, cards=1)
    assert s.ticks == 0 and s.idle_s == {} and s.launches == {}
    assert s.host_s == {UNSPANNED: pytest.approx(0.020)}
    assert readings(s) == {"idle_in_step_ms_per_tick": None,
                           "idle_unattributed_ms_per_tick": None}


def test_a_traced_cpu_run_with_the_tracer_armed(bench_copy):
    cell = spec.load_cell(bench_copy.add_cell("tiny"), root=bench_copy.root)
    result, _lines, prof = traced_run(cell, 2**31 + 77, 3.0, device="cpu")
    assert result["correct"] is True
    assert prof.spans and prof.w0_ns < prof.w1_ns and prof.fleet_ticks > 0
    for part in (prof.host_ms, prof.traced_ms):
        assert part["drain"] > 0 and part["dispatch"] > 0
    s = split_idle(prof.correlated_events(), prof.spans, prof.w0_ns, prof.w1_ns, 1)
    assert s.ticks > 0
    assert sum(s.host_s.values()) == pytest.approx(s.window_s)
    assert {"tick.drain", "step.dispatch", "step.decide_match"} <= set(s.host_s)
    # no card: nothing ran on a device
    assert s.idle_s == {} and s.launches == {}
    # the harness's profiler is as it was
    assert cell_mod.Profile.__name__ == "Profile"
