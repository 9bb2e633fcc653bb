from .client import Client, MultiClusterClient
from .informer import Informer, SharedInformerFactory

__all__ = ["Client", "MultiClusterClient", "Informer", "SharedInformerFactory"]
