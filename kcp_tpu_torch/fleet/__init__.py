"""Fleet state: the cluster inventory the deployment splitter owns."""

from .inventory import ClusterInventory, FleetView, ObservedDelta

__all__ = ["ClusterInventory", "FleetView", "ObservedDelta"]
