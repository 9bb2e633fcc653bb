from .selectors import LabelSelector, parse_selector
from .store import WILDCARD, Event, LogicalStore, Watch

__all__ = [
    "LogicalStore",
    "Event",
    "Watch",
    "WILDCARD",
    "LabelSelector",
    "parse_selector",
]
