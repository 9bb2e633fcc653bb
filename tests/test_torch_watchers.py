"""The port's ``--watchers`` lane (``python -m kcp_tpu_torch.bench
--watchers``) against the reference's ``bench.py --watchers``, on the CPU.

At a small shape (64 streams, 2,000 objects, 4 clusters, an A/B of 16
watchers) the lane's key tree equals ``BENCH_r06_watchers.json``'s plus
``card`` and ``note``, and its behavioural gates hold: every stream
established, the coalesced and per-batch A/B streams equal byte for byte
and line for line, and the evict drill green (the slow watcher evicted
with a terminal typed 410, the healthy one keeps every event). The
delivery p99, the RSS figures and the flush reduction are timings and
sizes of the card machine (``chip_smoke.py`` phase 17), not of this host.

Then the server children themselves: the port's ``--watchers-serve`` and
the reference's, seeded alike and driven by one pipelined update
schedule, must put the same bytes on every watch stream, in both flush
modes.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from kcp_tpu_torch import bench
from test_torch_shardbench import _committed, _lane, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WATCHERS_SMALL = {"KCP_BENCH_WATCHERS": "64", "KCP_BENCH_WATCH_OBJECTS": "2000",
                  "KCP_BENCH_WATCH_CLUSTERS": "4", "KCP_BENCH_WATCH_MUTS": "100",
                  "KCP_BENCH_WATCH_AB": "16", "KCP_BENCH_WATCH_AB_MUTS": "100"}


def test_watchers_lane(monkeypatch, capsys):
    r = _lane("--watchers", WATCHERS_SMALL, monkeypatch, capsys)
    assert tree(r) == tree(_committed("BENCH_r06_watchers.json"))
    wb = r["watchers_bench"]
    sc, ab, drill = wb["scale"], wb["ab"], wb["evict_drill"]
    assert r["metric"] == "watch_flush_reduction" and r["value"] == ab["flush_reduction"]
    assert sc["watchers"] == 64 and sc["objects"] == 2000 and sc["clusters"] == 4
    assert sc["streams_established"] == sc["watchers"], sc
    # each burst of 50 updates reaches every stream of its cluster: 32
    # streams for the first, all 64 for the second and the soak
    assert sc["lines_delivered"] == 50 * (32 // 4 + 2 * 64 // 4), sc
    assert sc["delivery_p99_ms"] is not None and sc["evicted"] == 0, sc
    assert ab["watchers"] == 16 and ab["bytes_equal"] and ab["lines_equal"], ab
    assert ab["flushes_coalesced"] > 0 and ab["flushes_per_batch"] > 0, ab
    assert drill["ok"] and drill["terminal_410"] and drill["evicted_total"] >= 1, drill
    assert drill["healthy_lines"] >= drill["healthy_expected"] == 400, drill


def _spawn(argv: list[str], coalesce: bool):
    env = {k: v for k, v in os.environ.items() if not k.startswith("KCP_")}
    env.update(JAX_PLATFORMS="cpu", KCP_WB_OBJECTS="400", KCP_WB_CLUSTERS="2",
               KCP_WATCH_COALESCE="1" if coalesce else "0", KCP_WATCH_FLUSH_MS="20")
    p = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         env=env, text=True, cwd=REPO)
    info = json.loads(p.stdout.readline())
    host, port = info["addr"].rsplit("//", 1)[1].rsplit(":", 1)
    return p, host, int(port)


async def _streams(host: str, port: int, watchers: int, writes: int) -> dict:
    """Every watcher's stream sha256 after one pipelined update schedule."""
    stats = bench._WatcherStats()
    ready = [asyncio.Event() for _ in range(watchers)]
    tasks = [asyncio.ensure_future(bench._wb_watcher(
        i, host, port, f"w{i % 2}", stats, ready[i], hash_lines=True))
        for i in range(watchers)]
    try:
        await asyncio.gather(*(e.wait() for e in ready))
        schedule = [(f"w{k % 2}", f"cm-{(7 * k) % 200}") for k in range(writes)]
        await bench._wb_mutate_pipelined(host, port, schedule, stats, pace_s=0.001)
        for _ in range(200):
            if stats.lines >= writes * watchers // 2:
                break
            await asyncio.sleep(0.05)
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    assert stats.lines == writes * watchers // 2
    return stats.hashes


@pytest.mark.parametrize("coalesce", [False, True], ids=["per_batch", "coalesced"])
def test_watch_streams_byte_equal_the_reference(coalesce):
    hashes = {}
    for side, argv in (("port", bench.WATCHERS_SERVE_ARGV),
                       ("reference", [sys.executable, os.path.join(REPO, "bench.py"),
                                      "--watchers-serve"])):
        p, host, port = _spawn(argv, coalesce)
        try:
            hashes[side] = asyncio.run(_streams(host, port, 6, 60))
        finally:
            bench._stop_all([p])
    assert len(hashes["port"]) == 6
    assert hashes["port"] == hashes["reference"]
