"""Device-batched fleet bin-pack: one batched program for every workload
(the port of ``kcp_tpu.fleet.solver``).

The placement question at fleet scale is [W x P]: W workloads (one row
per root Deployment), P physical clusters. Per row the solver scores the
candidate clusters, selects the top-k (spread constraint), and deals the
replicas proportionally to allocatable capacity — all as one batched
torch program over the [W, P] matrix (`solve_batched`), so a 10k-
workspace re-solve is a single device dispatch instead of 10k host loops.

Determinism is the whole contract: the score is integer, ties break on
column id (stable argsort of the negated score), and the weighted deal is
integer floor-division with the remainder going to the best-ranked
clusters (`ops.placement.split_replicas_weighted`). `solve_host` is the
numpy twin built from the same ops; the device program and the twin give
byte-identical assignments (tests/test_torch_fleet.py).

Overflow bounds (int32): weights clip at 2^15-1 and demand at 2^16-1 so
`demand * weight` stays below 2^31. Every lane stays int32: torch widens
sums, argsorts and Python-int operands to int64, so each is cast back or
kept out of a two-scalar `where`.

`FleetSolver` adds the incremental layer: a [W, P] assignment cache where
a re-solve gathers only the rows whose candidate set changed (the
inventory's delta), runs the padded device program over that subset, and
scatters the results back — plus an optional mesh from parallel/mesh.py
to shard the row dimension of solves across devices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..faults import maybe_fail
from ..ops.encode import pad_pow2
from ..ops.placement import split_replicas_weighted
from ..parallel.mesh import FLAGS, REPLICATED, ShardedTensor, gather_blocks, row_factor
from ..utils.device import resolve_device
from ..utils.trace import REGISTRY

CAP_CLIP = 32767      # weight clip: demand * weight < 2^31 (int32)
DEMAND_CLIP = 65535
DEFAULT_LOCALITY_WEIGHT = 1024  # outweighs any capacity delta < 2^10
_INT32_MAX = 2**31 - 1


def _select_rows(cand, alloc2, region2, home_region, spread: int,
                 locality_weight: int):
    """Score + top-k selection for every workload row at once (the
    reference vmaps this over rows; here it is batched on the last axis).

    score = locality_weight * in-home-region + min(alloc, CAP_CLIP);
    eligibility = candidate with positive allocatable. The rank is the
    stable argsort-of-argsort: rank r means "r clusters score strictly
    better or tie with a lower column id" — so selected columns occupy
    ranks 0..k-1 exactly, which split_replicas_weighted relies on.
    """
    elig = cand & (alloc2 > 0)
    w = alloc2.clamp(max=CAP_CLIP)
    # a bool * Python int product stays int32 (a where of two Python
    # scalars would give int64)
    score = (region2 == home_region[:, None]).to(torch.int32) * locality_weight + w
    neg = torch.where(elig, -score, _INT32_MAX).to(torch.int32)
    order = torch.argsort(neg, dim=-1, stable=True)        # score desc, col asc
    rank = torch.argsort(order, dim=-1, stable=True).to(torch.int32)
    n_elig = elig.sum(dim=-1, dtype=torch.int32)
    k = n_elig.clamp(max=spread) if spread > 0 else n_elig
    sel = elig & (rank < k[:, None])
    return sel, rank, w


def solve_batched(demand: torch.Tensor, cand: torch.Tensor, alloc: torch.Tensor,
                  region: torch.Tensor, home_region: torch.Tensor, spread: int,
                  locality_weight: int) -> torch.Tensor:
    """The device program: [W] demand, [W,P] bool candidates, [P] (or
    [W,P]) capacity/region vectors, [W] home region, all tensors on one
    device; ``spread`` and ``locality_weight`` are Python ints. Returns
    the int32 [W,P] assignment on that device, with no host sync."""
    alloc2 = alloc.to(torch.int32).expand(cand.shape)
    region2 = region.to(torch.int32).expand(cand.shape)
    sel, rank, w = _select_rows(cand, alloc2, region2, home_region.to(torch.int32),
                                int(spread), int(locality_weight))
    return split_replicas_weighted(demand.clamp(max=DEMAND_CLIP).to(torch.int32),
                                   w, sel, rank)


def solve_host(demand, cand, alloc, region, home_region, spread=0,
               locality_weight=DEFAULT_LOCALITY_WEIGHT) -> np.ndarray:
    """Numpy twin of solve_batched — the same integer ops in the same
    order, so assignments match the device program byte-for-byte."""
    demand = np.minimum(np.asarray(demand, np.int32), DEMAND_CLIP)
    cand = np.asarray(cand, bool)
    alloc2 = np.broadcast_to(np.asarray(alloc, np.int32), cand.shape)
    region2 = np.broadcast_to(np.asarray(region, np.int32), cand.shape)
    home = np.asarray(home_region, np.int32)
    elig = cand & (alloc2 > 0)
    w = np.minimum(alloc2, CAP_CLIP).astype(np.int32)
    score = np.where(region2 == home[:, None], np.int32(locality_weight),
                     np.int32(0)) + w
    neg = np.where(elig, -score, np.int32(_INT32_MAX)).astype(np.int32)
    order = np.argsort(neg, axis=-1, kind="stable")
    rank = np.argsort(order, axis=-1, kind="stable").astype(np.int32)
    n_elig = elig.sum(axis=-1).astype(np.int32)
    k = np.where(spread > 0, np.minimum(np.int32(spread), n_elig), n_elig)
    sel = elig & (rank < k[:, None])
    wsel = np.where(sel, w, 0).astype(np.int32)
    total = wsel.sum(axis=-1, keepdims=True)
    base = (demand[:, None] * wsel) // np.maximum(total, 1)
    rem = demand - base.sum(axis=-1)
    extra = (rank < rem[:, None]) & sel
    return np.where(sel & (total > 0),
                    base + extra.astype(np.int32), 0).astype(np.int32)


def solve_sharded(mesh, demand, cand, alloc, region, home_region, spread=0,
                  locality_weight=DEFAULT_LOCALITY_WEIGHT) -> np.ndarray:
    """Full solve with the row dimension sharded over a parallel/mesh.py
    mesh (rows over hosts x tenants like every [B] batch dimension, each
    row block whole on its row shard's device; the [P] fleet vectors
    replicate). Rows pad to the mesh's row factor; each row shard solves
    its block on its own device and the blocks concatenate on the host. On
    a mesh whose row shards span processes, each process solves its own
    blocks and the others' arrive through ``parallel.mesh.gather_blocks``."""
    W = int(np.asarray(demand).shape[0])
    rows = row_factor(mesh)
    Wp = max(((W + rows - 1) // rows) * rows, rows)

    def put_rows(a):
        a = np.asarray(a)
        out = np.zeros((Wp,) + a.shape[1:], a.dtype)
        out[:W] = a
        return ShardedTensor.put(torch.from_numpy(out), mesh, FLAGS)

    def put_all(a):
        return ShardedTensor.put(torch.from_numpy(np.asarray(a, np.int32)),
                                 mesh, REPLICATED)

    d = put_rows(np.asarray(demand, np.int32))
    c = put_rows(np.asarray(cand, bool))
    h = put_rows(np.asarray(home_region, np.int32))
    a, r = put_all(alloc), put_all(region)
    blocks = gather_blocks(mesh, {
        i: (solve_batched(d.blocks[i][0], c.blocks[i][0], a.blocks[i][0],
                          r.blocks[i][0], h.blocks[i][0], spread, locality_weight),)
        for i in mesh.local_rows}, [hi - lo for lo, hi in d.bounds])
    return np.concatenate([b[0].cpu().numpy() for b in blocks])[:W]


class FleetSolver:
    """Incremental wrapper: a [W, P] assignment cache where re-solves
    gather only the changed rows through the (padded, shape-stable)
    device program and scatter the results back.

    ``backend="fused"`` solves on ``device`` (``None`` is the CUDA card,
    or the lead of ``mesh``; a mesh shards the rows of every solve);
    ``"host"`` runs :func:`solve_host` and needs no device."""

    def __init__(self, spread: int = 0,
                 locality_weight: int = DEFAULT_LOCALITY_WEIGHT,
                 backend: str = "fused", mesh=None, device=None):
        if backend not in ("fused", "host"):
            raise ValueError(f"backend must be 'fused' or 'host', got {backend!r}")
        self.spread = int(spread)
        self.locality_weight = int(locality_weight)
        self.backend = backend
        self.mesh = mesh
        self.device = resolve_device(device, mesh) if backend == "fused" else None
        self._counts: np.ndarray | None = None
        self.stats = {"solves": 0, "rows_solved": 0, "rows_skipped": 0}

    def solve(self, demand, cand, alloc, region, home_region,
              rows=None) -> np.ndarray:
        """Solve and return the full [W, P] assignment. ``rows`` (int
        indices) restricts the device dispatch to those rows when the
        cached shape still matches — the inventory-delta fast path."""
        delay = maybe_fail("fleet.solve")
        if delay:
            time.sleep(delay)
        t0 = time.perf_counter()
        demand = np.asarray(demand, np.int32)
        cand = np.asarray(cand, bool)
        W, P = cand.shape
        full = (rows is None or self._counts is None
                or self._counts.shape != (W, P))
        idx = np.arange(W) if full else np.unique(
            np.asarray(rows, np.int64))
        self.stats["solves"] += 1
        self.stats["rows_solved"] += int(idx.size)
        self.stats["rows_skipped"] += W - int(idx.size)
        if full:
            self._counts = np.zeros((W, P), np.int32)
        if idx.size:
            sub = self._dispatch(demand[idx], cand[idx], alloc, region,
                                 np.asarray(home_region, np.int32)[idx])
            self._counts[idx] = sub
        REGISTRY.histogram(
            "fleet_solve_seconds",
            "fleet bin-pack solve latency").observe(time.perf_counter() - t0)
        return self._counts

    def _dispatch(self, demand, cand, alloc, region, home) -> np.ndarray:
        if self.backend != "fused":
            return solve_host(demand, cand, alloc, region, home,
                              self.spread, self.locality_weight)
        if self.mesh is not None:
            return solve_sharded(self.mesh, demand, cand, alloc, region,
                                 home, self.spread, self.locality_weight)
        n, P = cand.shape
        npad, ppad = pad_pow2(max(n, 1)), pad_pow2(max(P, 1))
        # the five inputs staged in one int32 buffer: one host->device
        # copy, and the result's copy back is the solve's only sync
        buf = np.zeros(2 * npad + 2 * ppad + npad * ppad, np.int32)
        buf[:n] = demand
        buf[npad:npad + n] = home
        buf[2 * npad:2 * npad + P] = np.asarray(alloc, np.int32)
        buf[2 * npad + ppad:2 * npad + ppad + P] = np.asarray(region, np.int32)
        buf[2 * npad + 2 * ppad:].reshape(npad, ppad)[:n, :P] = cand
        dev = torch.from_numpy(buf).to(self.device)
        d, h = dev[:npad], dev[npad:2 * npad]
        a, r = dev[2 * npad:2 * npad + ppad], dev[2 * npad + ppad:2 * npad + 2 * ppad]
        c = dev[2 * npad + 2 * ppad:].view(npad, ppad) != 0
        out = solve_batched(d, c, a, r, h, self.spread, self.locality_weight)
        return out.cpu().numpy()[:n, :P]
