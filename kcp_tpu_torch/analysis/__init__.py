"""Runtime contract checks (the port's copy of ``kcp_tpu.analysis.sanitize``)."""
