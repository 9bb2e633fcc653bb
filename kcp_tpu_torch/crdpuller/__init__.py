from .puller import SchemaPuller

__all__ = ["SchemaPuller"]
