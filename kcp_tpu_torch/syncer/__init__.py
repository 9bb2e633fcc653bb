"""The sync engines and the serving core: ``start_syncer`` /
``Syncer`` / ``BatchSyncEngine`` over the fused core (``core.py``)."""

from .engine import BatchSyncEngine, transform_for_downstream
from .syncer import Syncer, start_syncer

__all__ = ["BatchSyncEngine", "Syncer", "start_syncer", "transform_for_downstream"]
