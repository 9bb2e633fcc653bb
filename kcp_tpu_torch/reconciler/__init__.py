"""Reconcile runtime: work queues and the batch controller."""

from .controller import Controller
from .queue import WorkQueue

__all__ = ["Controller", "WorkQueue"]
