from .client import Client, MultiClusterClient
from .informer import Informer, SharedInformerFactory

__all__ = ["Client", "MultiClusterClient", "Informer", "SharedInformerFactory",
           "SmartRestClient", "SmartMultiClusterRestClient", "rest_client",
           "multicluster_rest_client", "smart_enabled"]

_SMART = {"SmartRestClient", "SmartMultiClusterRestClient", "rest_client",
          "multicluster_rest_client", "smart_enabled"}


def __getattr__(name: str):
    # lazy: kcp_tpu_torch.client.smart pulls in the server package (RestClient,
    # pools); importing it eagerly here would make `import kcp_tpu_torch.client`
    # load the whole serving stack
    if name in _SMART:
        from . import smart

        return getattr(smart, name)
    raise AttributeError(name)
