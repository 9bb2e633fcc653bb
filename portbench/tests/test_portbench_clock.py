"""The program's spans and the profiler's events share one clock: work done
inside an ``obs.TRACER`` span lies inside that span's bounds in the
profile (``trace.Profile``), with no offset applied. On the CPU, the
profiler's own ops; on the card (marker ``cuda``), a kernel launched
inside a span and waited for with ``synchronize()``."""

import pytest
import torch

from kcp_tpu_torch import obs
from portbench.trace import Profile

#: spans are recorded with microsecond-rounded bounds
EPS_NS = 1_000


@pytest.fixture
def tracer(monkeypatch):
    for k in ("KCP_TRACE", "KCP_TRACE_SAMPLE", "KCP_TRACE_SEED"):
        monkeypatch.delenv(k, raising=False)
    obs.TRACER.reconfigure()
    yield obs.TRACER
    obs.TRACER.disarm()


def _traced(prof: Profile, work) -> dict:
    """Run ``work`` inside one span while ``prof`` records; the span."""
    prof.prepare()
    prof.record()
    obs.TRACER.arm()
    try:
        with obs.use(obs.TRACER.tick_context()):
            with obs.span("step.decide_match"):
                work()
    finally:
        spans = obs.TRACER.disarm()
        prof.stop()
    (span,) = spans
    return span


def _inside(events, span: dict) -> list:
    t0 = round(span["t0"] * 1e9)
    t1 = round((span["t0"] + span["dur"]) * 1e9)
    return [e for e in events if t0 - EPS_NS <= e[3] and e[3] + e[4] <= t1 + EPS_NS]


def test_cpu_ops_done_in_a_span_lie_inside_it(tracer):
    prof = Profile(cuda=False)
    x = torch.ones(1 << 16)
    span = _traced(prof, lambda: x.cumsum(0).sum())
    ops = [e for e in prof.events() if e[0] in ("aten::cumsum", "aten::sum")]
    assert len(ops) >= 2
    assert _inside(ops, span) == ops


@pytest.mark.cuda
def test_a_synchronized_kernel_lies_inside_its_span_on_the_card(tracer):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    x = torch.ones(1 << 24, device="cuda")
    x.cumsum(0)
    torch.cuda.synchronize()
    prof = Profile(cuda=True)

    def work():
        x.cumsum(0)
        torch.cuda.synchronize()

    span = _traced(prof, work)
    kernels = [e for e in prof.events() if e[1]]
    assert kernels, "the profile holds no device event"
    t0 = round(span["t0"] * 1e9)
    offsets = [(e[3] - t0, e[3] + e[4] - t0 - round(span["dur"] * 1e9)) for e in kernels]
    assert _inside(kernels, span) == kernels, offsets
