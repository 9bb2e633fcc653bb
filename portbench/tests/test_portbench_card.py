"""The harness's cell code on the card at a tiny size: the kernel, the
profile's readers and the control. Marker ``cuda``; skipped without a card."""

import time

import pytest
import torch

from portbench import spec
from portbench.cell import run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def test_a_tiny_cell_on_the_card(card, bench_copy):
    cell = spec.load_cell(bench_copy.add_cell("tiny", rows=16384, traffic="trickle64"),
                          root=bench_copy.root)
    result, _ = run_cell(cell, 2**31 + 1, 2.0, False, time.perf_counter())
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    traced, _ = run_cell(cell, 2**31 + 2, 3.0, True, time.perf_counter())
    assert traced["correct"] is True
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert m["launches_per_tick"] > 0
    assert 0 < m["device_idle_pct"] < 100
    assert 0 < m["decide_and_match_roofline"] <= 105
    control, _ = run_cell(cell, 2**31 + 3, 1.0, False, time.perf_counter(), control=True)
    assert control["correct"] is False
