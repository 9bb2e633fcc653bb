"""Syncer: per-cluster sync session over a set of resources (the port of
``kcp_tpu.syncer.syncer``).

The analog of the reference's Syncer (pkg/syncer/syncer.go:46-64
StartSyncer: one spec controller + one status controller per registered
cluster). Here a Syncer owns one :class:`BatchSyncEngine` per GVR — each
engine computes both sync directions in one batched program.

Parity details:
- resources that don't exist yet raise RetryableError, so the caller's
  workqueue retries forever instead of burning its 5-retry budget
  (syncer.go:143-215 getAllGVRs + RetryableError)
- push mode runs these engines in-process; pull mode packages the same
  code to run inside the physical cluster (cli/syncer_main.py)
"""

from __future__ import annotations

import asyncio
import logging

from ..apis.scheme import GVR
from ..client import Client
from ..utils.errors import RetryableError

from .engine import BatchSyncEngine

log = logging.getLogger(__name__)


def discover_gvrs(client: Client, resources: list[str]) -> list[str]:
    """Resolve requested resource names against the upstream's served set.

    Raises RetryableError while any requested resource is not served yet
    (e.g. its negotiated CRD has not been published) — mirroring
    getAllGVRs' retry-until-discovered contract.
    """
    served = set(client.resources())
    missing = [r for r in resources if GVR.parse(r).storage_name not in served]
    if missing:
        raise RetryableError(f"resources not served yet: {missing}")
    return [GVR.parse(r).storage_name for r in resources]


class Syncer:
    def __init__(
        self,
        upstream: Client,
        downstream: Client,
        resources: list[str],
        cluster_id: str,
        backend: str = "fused",
        mesh=None,
        resync_period: float | None = None,
        device=None,
    ):
        self.cluster_id = cluster_id
        self.resources = list(resources)
        kw = {}
        if resync_period is not None:
            # the missed-event / dropped-key safety net (reference:
            # resyncPeriod, pkg/syncer/syncer.go:27) — tunable from the
            # top-level API so operators can trade heal latency for churn
            kw["resync_period"] = resync_period
        self.engines = [
            BatchSyncEngine(upstream, downstream, gvr, cluster_id,
                            backend=backend, mesh=mesh, device=device, **kw)
            for gvr in resources
        ]
        self._started = False

    async def start(self) -> None:
        await asyncio.gather(*(e.start() for e in self.engines))
        self._started = True
        log.info("syncer for cluster %s started (%d resources)",
                 self.cluster_id, len(self.engines))

    async def stop(self) -> None:
        if self._started:
            await asyncio.gather(*(e.stop() for e in self.engines))
            self._started = False

    # observability: aggregate convergence + throughput over engines
    def stats(self) -> dict:
        # fused engines sharing a bucket share its tick counter — count
        # each bucket once, not once per engine
        ticks, seen = 0, set()
        for e in self.engines:
            if e.fused and e._section is not None:
                b = e._section.bucket
                if id(b) not in seen:
                    seen.add(id(b))
                    ticks += b.stats["ticks"]
            else:
                ticks += e.stats["ticks"]
        applied = sum(e.stats["decisions_applied"] for e in self.engines)
        samples = [s for e in self.engines for s in e.convergence_samples]
        samples.sort()
        p99 = samples[int(len(samples) * 0.99)] if samples else None
        return {
            "cluster": self.cluster_id,
            "ticks": ticks,
            "decisions_applied": applied,
            "convergence_p99_s": p99,
        }


async def start_syncer(
    upstream: Client,
    downstream: Client,
    resources: list[str],
    cluster_id: str,
    backend: str = "fused",
    mesh=None,
    resync_period: float | None = None,
    device=None,
) -> Syncer:
    """Push-mode entry point (reference: StartSyncer, syncer.go:46-64).

    Validates the resource set via discovery first (retryable while the
    upstream does not serve a requested resource yet). ``mesh`` shards
    the fused serving core's buckets over a device mesh
    (:func:`kcp_tpu_torch.parallel.mesh.mesh_from_spec`); None uses the
    process serving mesh. ``device=None`` is
    the CUDA card; pass ``device="cpu"`` on a host without one.
    """
    discover_gvrs(upstream, resources)
    s = Syncer(upstream, downstream, resources, cluster_id, backend=backend,
               mesh=mesh, resync_period=resync_period, device=device)
    await s.start()
    return s
