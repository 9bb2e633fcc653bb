"""Device ops of the reconcile tick, as torch tensor code plus one CUDA kernel."""
