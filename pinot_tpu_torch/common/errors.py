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



class SegmentCorruptedError(ValueError):
    """A segment failed CRC / structural verification. Subclasses ValueError
    (corrupt bytes are malformed values), as the JAX package's does, so
    callers that guard segment decode with `except ValueError` keep working;
    `error_code` maps it to SEGMENT_CORRUPTED and `path` names the bad copy."""

    error_code = QueryErrorCode.SEGMENT_CORRUPTED

    def __init__(self, message: str, path: str | None = None):
        super().__init__(message)
        self.path = path
