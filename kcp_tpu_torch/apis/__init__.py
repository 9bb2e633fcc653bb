from .conditions import (
    find_condition,
    is_condition_true,
    set_condition,
)
from .scheme import GVR, Scheme, default_scheme

__all__ = [
    "set_condition",
    "find_condition",
    "is_condition_true",
    "GVR",
    "Scheme",
    "default_scheme",
]
