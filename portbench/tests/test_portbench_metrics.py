"""Each metric reader on a fixed synthetic profile."""

import numpy as np
import pytest

from portbench import spec
from portbench.cell import Context
from portbench.kernels import decide_and_match_bytes
from portbench.trace import reduce_events

MS = 1_000_000  # ns
H100 = "NVIDIA H100 80GB HBM3"


def _profile():
    # one card, 100 ms traced, 10 ticks: two kernels overlap (count once),
    # a copy, the kernel twice
    events = [
        ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", True, 0, 0, 10 * MS),
        ("void at::native::reduce_kernel<512, 1>(...)", True, 0, 5 * MS, 10 * MS),
        ("Memcpy HtoD (Pinned -> Device)", True, 0, 40 * MS, 1 * MS),
        ("(anonymous namespace)::decide_match_kernel(Args)", True, 0, 50 * MS, 2 * MS),
        ("(anonymous namespace)::decide_match_kernel(Args)", True, 0, 60 * MS, 2 * MS),
        ("cudaLaunchKernel", False, 0, 0, 90 * MS),
    ]
    return reduce_events(events, window_s=0.1, ticks=10, cards=1)


def _ctx(**kw):
    base = dict(rows=131072, objects=100000, slots=64, kind=H100, trace=_profile(), ticks=100,
                window_s=2.0, setup_s=3.5, host_ticks=50, host_seconds=1.0,
                host_phases={"encode": (0.05, 50), "collect_wait": (0.01, 50),
                             "pack": (0.02, 50), "put": (0.005, 50),
                             "step_dispatch": (0.3, 50)},
                gc_s=0.004, latencies_ms=np.arange(1, 101, dtype=float),
                host_latencies_ms=np.arange(1, 201, dtype=float))
    base.update(kw)
    return Context(**base)


def read(name, **kw):
    return spec.reader(name)(_ctx(**kw))


def test_the_idle_share_takes_the_union_of_overlapping_intervals():
    t = _profile()
    assert t.busy_s == pytest.approx(0.020)  # 0-15, 40-41, 50-52, 60-62 ms
    assert t.launches == 4  # the copy is no launch
    assert read("device_idle_pct") == pytest.approx(80.0)
    assert read("device_ms_per_tick") == pytest.approx(2.0)
    assert read("launches_per_tick") == pytest.approx(0.4)
    assert t.idle_gaps[0] == ("host_work_before_Memcpy HtoD", pytest.approx(0.025))
    assert t.ops["decide_match_kernel"] == (2, pytest.approx(0.004))


def test_the_roofline_counts_the_call_s_bytes_over_the_kernel_time():
    bound = 77_070_432 / 3.35e12
    assert decide_and_match_bytes(131072, 64) == 77_070_432
    assert read("decide_and_match_roofline") == pytest.approx(100 * bound / 0.0004)


def test_device_readers_stay_silent_with_nothing_to_read():
    empty = reduce_events([], window_s=1.0, ticks=5, cards=1)
    for name in ("device_idle_pct", "device_ms_per_tick", "launches_per_tick",
                 "decide_and_match_roofline"):
        assert read(name, trace=None) is None
        assert read(name, trace=empty) is None
    assert read("decide_and_match_roofline", kind="some other card") is None


def test_host_readers():
    assert read("reconciles_per_s") == pytest.approx(100000 * 100 / 2.0)
    assert read("setup_s") == 3.5
    assert read("convergence_p99_ms") == pytest.approx(np.percentile(np.arange(1, 201), 99))
    assert read("convergence_p99_ms", host_latencies_ms=np.zeros(0)) is None
    assert read("encode_ms_per_tick") == pytest.approx(1.0)
    assert read("collect_wait_ms_per_tick") == pytest.approx(0.2)
    assert read("pack_ms_per_tick") == pytest.approx(0.5)
    assert read("step_dispatch_ms_per_tick") == pytest.approx(6.0)
    assert read("gc_pause_ms_per_s") == pytest.approx(4.0)


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec._read_json(f"{spec.ROOT}/BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
