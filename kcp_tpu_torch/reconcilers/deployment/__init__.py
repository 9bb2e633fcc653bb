from .controller import DeploymentSplitter

__all__ = ["DeploymentSplitter"]
