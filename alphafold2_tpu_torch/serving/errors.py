"""Serving-engine errors (counterpart of alphafold2_tpu/serving/errors.py,
copied: the port imports nothing of the JAX package).

Every rejection the engine hands a client is a typed error with a STABLE
`code` string: error-rate dashboards, client retry policies and the
engine's per-code counters in `stats()["errors"]` key on it, so the codes
are the JAX package's, byte for byte (tests/test_torch_serving.py holds
them against it). `to_json()` is the wire format. Load-shedding
rejections carry `retry_after_s`, the server's backoff advice. The fleet
tier's codes are here too, so a client of either tier sees one code set.
"""

from __future__ import annotations

from typing import Optional


class ServingError(Exception):
    """Base class for all serving errors. `retry_after_s` is optional
    backoff advice for retryable rejections."""

    code = "serving_error"
    retry_after_s: Optional[float] = None
    #: the HTTP status a front end maps this error to (429 for sheds that
    #: carry retry advice, 500 otherwise)
    http_status = 500

    def __init__(self, *args, retry_after_s: Optional[float] = None):
        super().__init__(*args)
        if retry_after_s is not None:
            self.retry_after_s = float(retry_after_s)

    def to_json(self) -> dict:
        """Wire-format payload: stable code + message (+ retry_after_s)."""
        payload = {"code": self.code, "error": type(self).__name__, "message": str(self)}
        if self.retry_after_s is not None:
            payload["retry_after_s"] = round(self.retry_after_s, 3)
        return payload


class InvalidSequenceError(ServingError):
    """The sequence is empty or holds characters outside the residue
    vocabulary."""

    code = "invalid_sequence"


class RequestTooLongError(ServingError):
    """The sequence is longer than the largest configured bucket."""

    code = "request_too_long"


class SequenceTooLongError(RequestTooLongError):
    """The sequence exceeds every bucket this deployment serves (the
    ladder's rejection), with its own code."""

    code = "sequence_too_long"


class QueueFullError(ServingError):
    """The bounded request queue is at capacity: backpressure is explicit,
    the engine never blocks a submitter."""

    code = "queue_full"
    http_status = 429


class RequestTimeoutError(ServingError):
    """The request's deadline passed before it was dispatched."""

    code = "request_timeout"


class PredictionError(ServingError):
    """The model call for this request raised (chained as __cause__); the
    engine keeps serving."""

    code = "prediction_failed"


class EngineClosedError(ServingError):
    """The engine is shut down; the request was not and will not be served."""

    code = "engine_closed"


class CircuitOpenError(ServingError):
    """The circuit breaker is open: the engine fast-rejects instead of
    queueing work it expects to fail (reliability/breaker.py)."""

    code = "circuit_open"


class HungBatchError(ServingError):
    """The batch's model call exceeded the hung-batch watchdog; its
    requests failed and the worker kept serving."""

    code = "hung_batch"


class NoHealthyReplicaError(ServingError):
    """Fleet tier: no replica can serve the request."""

    code = "no_healthy_replica"


class RequeueLimitError(ServingError):
    """Fleet tier: the request failed over past its requeue limit."""

    code = "requeue_limit"


class FeaturizeError(ServingError):
    """Fleet tier: CPU featurization of the request failed."""

    code = "featurize_failed"


class RetryBudgetExhaustedError(ServingError):
    """Fleet tier: the fleet-wide retry budget is spent."""

    code = "retry_budget_exhausted"
    http_status = 429


class ScaleRejectedError(ServingError):
    """Fleet tier: a replica-pool scale action was refused."""

    code = "scale_rejected"
