"""Canonical status/error propagation, without grpcio.

One exception type carrying a canonical error code (tensorflow.error.Code,
whose numbers are also gRPC's status codes). The JAX package maps these
onto `grpc.StatusCode`; the port's in-process server raises `ServingError`
itself, so callers read `.code` as a plain integer.
"""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """tensorflow.error.Code (tf_error.proto); equal to gRPC status codes."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class ServingError(Exception):
    """Error with a canonical code, raised anywhere in the serving path."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = Code(code)
        self.message = message

    def __str__(self):
        return f"{self.code.name}: {self.message}"

    @classmethod
    def invalid_argument(cls, msg: str) -> "ServingError":
        return cls(Code.INVALID_ARGUMENT, msg)

    @classmethod
    def not_found(cls, msg: str) -> "ServingError":
        return cls(Code.NOT_FOUND, msg)

    @classmethod
    def internal(cls, msg: str) -> "ServingError":
        return cls(Code.INTERNAL, msg)

    @classmethod
    def unimplemented(cls, msg: str) -> "ServingError":
        return cls(Code.UNIMPLEMENTED, msg)


def error_from_exception(exc: Exception) -> ServingError:
    """The JAX package's mapping of Python exceptions onto codes."""
    if isinstance(exc, ServingError):
        return exc
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return ServingError(Code.INVALID_ARGUMENT, str(exc))
    if isinstance(exc, TimeoutError):
        return ServingError(Code.DEADLINE_EXCEEDED, str(exc))
    if isinstance(exc, NotImplementedError):
        return ServingError(Code.UNIMPLEMENTED, str(exc))
    return ServingError(Code.INTERNAL, f"{type(exc).__name__}: {exc}")
