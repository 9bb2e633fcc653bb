from .fake import ChurnDriver, FakeClusterAgent, PhysicalRegistry

__all__ = ["PhysicalRegistry", "FakeClusterAgent", "ChurnDriver"]
