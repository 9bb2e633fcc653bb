"""Fleet placement control plane: inventory -> batched solver -> scheduler.

Import :class:`FleetScheduler` from ``kcp_tpu_torch.fleet.scheduler``
directly — keeping it out of this namespace avoids an import cycle with
the deployment splitter (which owns a :class:`ClusterInventory`).
"""

from .inventory import ClusterInventory, FleetView, ObservedDelta
from .solver import FleetSolver, solve_batched, solve_host, solve_sharded

__all__ = [
    "ClusterInventory", "FleetView", "ObservedDelta",
    "FleetSolver", "solve_batched", "solve_host", "solve_sharded",
]
