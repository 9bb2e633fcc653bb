from .scheme import GVR, Scheme, default_scheme

__all__ = ["GVR", "Scheme", "default_scheme"]
