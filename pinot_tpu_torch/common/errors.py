"""Canonical registry of query error codes (QueryException parity).

Reference: org.apache.pinot.common.exception.QueryException assigns every
failure surface a stable numeric code that travels in BrokerResponse
`exceptions: [{"errorCode", "message"}]` entries so clients can react
without string-matching. The codes are the same numbers the JAX package
uses, so responses from either engine carry identical codes.
"""

from __future__ import annotations

import enum


class QueryErrorCode(enum.IntEnum):
    """Numeric query error codes (QueryException.*_ERROR_CODE parity)."""

    #: generic server-side execution failure
    QUERY_EXECUTION = 200

    #: query exceeded its deadline (EXECUTION_TIMEOUT_ERROR_CODE)
    EXECUTION_TIMEOUT = 250

    #: query was cancelled via DELETE /query/{id} (QueryCancelledException)
    QUERY_CANCELLATION = 503

    #: admission tier shed the query (SERVER_OUT_OF_CAPACITY_ERROR_CODE)
    SERVER_OUT_OF_CAPACITY = 211

    #: per-table / per-tenant QPS quota rejection (TOO_MANY_REQUESTS)
    QUOTA_EXCEEDED = 429

    #: a segment's bytes failed integrity verification
    SEGMENT_CORRUPTED = 260

    #: no controller candidate is reachable and leading
    CONTROLLER_UNAVAILABLE = 270

    #: a segment upload failed before any cluster metadata referenced it
    SEGMENT_UPLOAD = 290

    #: wire datatable (de)serialization failure between query hops
    DATA_TABLE_SERIALIZATION = 550


#: Error codes that map to a non-200 HTTP status at response boundaries.
#: Everything else stays the BrokerResponse convention: HTTP 200 with the
#: code inside `exceptions[]`. Shed/quota responses use real statuses so
#: load balancers and clients can back off without parsing the body.
_HTTP_STATUS_BY_CODE = {
    int(QueryErrorCode.SERVER_OUT_OF_CAPACITY): 503,
    int(QueryErrorCode.QUOTA_EXCEEDED): 429,
    int(QueryErrorCode.CONTROLLER_UNAVAILABLE): 503,
}


class SegmentCorruptedError(ValueError):
    """A segment failed CRC / structural verification. Subclasses ValueError
    (corrupt bytes are malformed values), as the JAX package's does, so
    callers that guard segment decode with `except ValueError` keep working;
    `error_code` maps it to SEGMENT_CORRUPTED and `path` names the bad copy."""

    error_code = QueryErrorCode.SEGMENT_CORRUPTED

    def __init__(self, message: str, path: str | None = None):
        super().__init__(message)
        self.path = path


class ControllerUnavailableError(ConnectionError):
    """Every configured controller candidate is down or refusing leadership
    (connection failures and 503s with no followable leaderUrl across the
    bounded retry budget). Subclasses ConnectionError so legacy callers that
    guard discovery with `except ConnectionError`/`except OSError` keep
    working; carries `error_code` so response boundaries surface a typed
    503 with Retry-After instead of an untyped stack."""

    error_code = QueryErrorCode.CONTROLLER_UNAVAILABLE

    def __init__(self, message: str, candidates: list[str] | None = None, retry_after_s: float = 1.0):
        super().__init__(message)
        self.candidates = list(candidates or [])
        self.retry_after_s = retry_after_s


class SegmentUploadError(OSError):
    """A segment upload failed before any cluster metadata referenced it
    (ENOSPC, crash, or the written bytes failing verification). The errno
    of the underlying OSError is preserved — `e.errno == errno.ENOSPC`
    is the disk-full contract — and the controller guarantees the deep
    store holds no partial segment dir when this is raised. Carries
    `error_code` so the controller HTTP boundary returns a typed failure
    instead of an anonymous 500."""

    error_code = QueryErrorCode.SEGMENT_UPLOAD


def code_of(exc: BaseException, default: int = QueryErrorCode.QUERY_EXECUTION) -> int:
    """Error code carried by an exception (its `error_code` attribute), or
    `default`. The one sanctioned way to map an arbitrary exception to a
    wire code at response boundaries."""
    return int(getattr(exc, "error_code", default))


def http_status_of(exc: BaseException) -> int | None:
    """HTTP status override for admission-tier rejections (503 shed /
    429 quota), or None for errors that ride in a 200 BrokerResponse."""
    return _HTTP_STATUS_BY_CODE.get(code_of(exc, default=0))


def retry_after_of(exc: BaseException, default: float = 1.0) -> float:
    """`Retry-After` seconds carried by an admission rejection (its
    `retry_after_s` attribute), floored at 1 s for header sanity."""
    v = getattr(exc, "retry_after_s", None)
    try:
        return max(1.0, float(v)) if v is not None else float(default)
    except (TypeError, ValueError):
        return float(default)
