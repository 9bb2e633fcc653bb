"""Error taxonomy the serving core needs (copy of ``kcp_tpu.utils.errors``).

Only the retry contract travels with this slice: a ``RetryableError`` is
retried without counting against the bounded retry budget; everything
else gets the workqueue's rate-limited retries. ``UnavailableError`` is
what an injected ``error`` fault raises (see :mod:`kcp_tpu_torch.faults`).
"""

from __future__ import annotations


class ApiError(Exception):
    """Base class for API-surface errors, carrying an HTTP-ish status code."""

    code = 500
    reason = "InternalError"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class UnavailableError(ApiError):
    """A dependency is (temporarily) unreachable or refusing service.

    Deliberately NOT a RetryableError: callers get the bounded workqueue
    retry budget, and a new event resets it."""

    code = 503
    reason = "ServiceUnavailable"


class RetryableError(Exception):
    """Marker wrapper: retry the operation without a bounded retry budget."""

    def __init__(self, cause: Exception | str):
        super().__init__(str(cause))
        self.cause = cause


def is_retryable(err: BaseException) -> bool:
    return isinstance(err, RetryableError)
