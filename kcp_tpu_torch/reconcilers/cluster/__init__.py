from .controller import ClusterController, SyncerMode

__all__ = ["ClusterController", "SyncerMode"]
