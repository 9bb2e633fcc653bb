"""PyTorch/CUDA port of kcp_tpu: the fused reconcile tick on an NVIDIA H100."""
