"""Reconcile runtime: work queues and the batch controller."""
