"""kcp_tpu_torch.obs — fleet-wide distributed tracing (the port's copy of
``kcp_tpu.obs``; see obs/trace.py)."""

from .trace import (
    PHASES,
    TRACEPARENT,
    TRACER,
    TraceContext,
    conv_begin,
    ctx_from_wal,
    current,
    link_obj,
    obj_link,
    phase,
    record_span,
    reset_current,
    set_current,
    span,
    use,
    write_ctx,
)

__all__ = [
    "PHASES", "TRACEPARENT", "TRACER", "TraceContext", "conv_begin",
    "ctx_from_wal", "current", "link_obj", "obj_link", "phase",
    "record_span", "reset_current", "set_current", "span", "use",
    "write_ctx",
]
