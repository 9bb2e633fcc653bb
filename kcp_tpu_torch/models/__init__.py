"""The fused reconcile step and its wire format."""
