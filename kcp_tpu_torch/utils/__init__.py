"""Host utilities of the port: errors, locks, metrics."""
