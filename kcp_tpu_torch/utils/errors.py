"""Error taxonomy for the control plane.

Mirrors the behavioral contract of the reference's apimachinery errors plus
its retryable-error marker (reference: pkg/util/errors/retryable.go:3-19):
a ``RetryableError`` is retried without counting against the bounded retry
budget; everything else gets the workqueue's 5 rate-limited retries.
"""

from __future__ import annotations


class ApiError(Exception):
    """Base class for API-surface errors, carrying an HTTP-ish status code."""

    code = 500
    reason = "InternalError"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """Optimistic-concurrency failure (stale resourceVersion)."""

    code = 409
    reason = "Conflict"


class GoneError(ConflictError):
    """410 Gone: the requested watch/list window has expired server-side
    (the apiserver's "too old resource version"). Subclasses
    :class:`ConflictError` so existing expired-window handling (which
    predates the dedicated type) keeps catching it; consumers that can
    react smarter — informers, the shard router's catchup path — match
    this type and re-list *immediately* instead of backoff-retrying a
    watch that can never be served."""

    code = 410
    reason = "Expired"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class BadRequestError(ApiError):
    code = 400
    reason = "BadRequest"


class ForbiddenError(ApiError):
    """Policy denial (quota exceeded, RBAC): the request is understood
    and well-formed but refused — retrying unchanged cannot succeed."""

    code = 403
    reason = "Forbidden"


class TooManyRequestsError(ApiError):
    """Flow-control rejection (429): the server is shedding load for this
    flow. ``retry_after`` carries the server's pacing hint in seconds —
    clients sleep (jittered, capped) instead of hammering an overloaded
    frontend; the REST surface mirrors it as a ``Retry-After`` header and
    a ``details.retryAfterSeconds`` Status field."""

    code = 429
    reason = "TooManyRequests"
    retry_after = 1.0


class UnavailableError(ApiError):
    """A dependency is (temporarily) unreachable or refusing service:
    injected 5xx faults, circuit-broken remote I/O, dead store backends.

    Deliberately NOT a RetryableError: callers get the bounded workqueue
    retry budget, and a new informer event resets it — an unavailable
    dependency must degrade, not spin."""

    code = 503
    reason = "ServiceUnavailable"


class FrontierTimeoutError(UnavailableError):
    """A consistent (RV-barrier) read timed out waiting for the replica
    to apply the required RV (KEP-2340 analog). 504 rather than 503: the
    replica is healthy but behind — the read itself, not the server, hit
    its freshness deadline. Subclasses :class:`UnavailableError` so
    generic 5xx handling (router fallback, smart-client re-route, writer
    backoff) keeps working; the router matches this type/status to fall
    back to the primary and meter the reason."""

    code = 504
    reason = "FrontierWaitTimeout"


class RetryableError(Exception):
    """Marker wrapper: retry the operation without a bounded retry budget.

    Reference behavior: pkg/util/errors/retryable.go defines NewRetryableError/
    IsRetryable; the syncer wraps not-yet-ready discovery in it
    (pkg/syncer/syncer.go:119-122, 152-163) and controller error handlers
    requeue such errors forever (pkg/reconciler/cluster/controller.go:253).
    """

    def __init__(self, cause: Exception | str):
        super().__init__(str(cause))
        self.cause = cause


def is_retryable(err: BaseException) -> bool:
    return isinstance(err, RetryableError)


def is_not_found(err: BaseException) -> bool:
    return isinstance(err, NotFoundError)


def is_conflict(err: BaseException) -> bool:
    return isinstance(err, ConflictError)


def is_already_exists(err: BaseException) -> bool:
    return isinstance(err, AlreadyExistsError)


def is_too_many_requests(err: BaseException) -> bool:
    return isinstance(err, TooManyRequestsError)


def is_gone(err: BaseException) -> bool:
    """True for an expired watch/list window (410): re-list now."""
    return isinstance(err, GoneError)


def retry_after_hint(err: BaseException) -> float | None:
    """The server's Retry-After pacing hint in seconds, if the error
    carries one (429 flow-control rejections do)."""
    ra = getattr(err, "retry_after", None)
    try:
        return float(ra) if ra is not None else None
    except (TypeError, ValueError):
        return None
