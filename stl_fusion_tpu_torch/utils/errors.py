"""Wire-safe exception transport.

Re-expression of ``ExceptionInfo`` (src/Stl/Serialization/ExceptionInfo.cs):
an exception captured as (type-name, message) that can cross a process
boundary and be reconstructed — as the original type when it's a registered
known type, else as ``RemoteError`` carrying the original type name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Type

__all__ = ["ExceptionInfo", "RemoteError", "TransientError", "ServiceError", "register_exception_type"]


class RemoteError(Exception):
    """An exception whose concrete type is unknown on this side of the wire."""

    def __init__(self, type_name: str, message: str):
        super().__init__(message)
        self.type_name = type_name

    def __str__(self) -> str:
        return f"{self.type_name}: {super().__str__()}"


class TransientError(Exception):
    """Marker base for retryable failures (≈ ITransientException)."""


class ServiceError(Exception):
    """Generic service-side failure."""


_KNOWN: Dict[str, Type[BaseException]] = {}


def register_exception_type(cls: Type[BaseException], name: Optional[str] = None) -> Type[BaseException]:
    """Register an exception type for faithful wire round-trips. Decorator-friendly."""
    _KNOWN[name or cls.__name__] = cls
    return cls


for _cls in (ValueError, KeyError, LookupError, IndexError, RuntimeError, TypeError,
             NotImplementedError, TimeoutError, PermissionError, ConnectionError,
             TransientError, ServiceError):
    register_exception_type(_cls)


@dataclass(frozen=True)
class ExceptionInfo:
    type_name: str
    message: str

    @staticmethod
    def capture(exc: BaseException) -> "ExceptionInfo":
        if isinstance(exc, RemoteError):
            return ExceptionInfo(exc.type_name, str(Exception.__str__(exc)))
        return ExceptionInfo(type(exc).__name__, str(exc))

    def to_exception(self) -> BaseException:
        cls = _KNOWN.get(self.type_name)
        if cls is not None:
            try:
                return cls(self.message)
            except Exception:  # noqa: BLE001 — constructor mismatch
                pass
        return RemoteError(self.type_name, self.message)

    def to_dict(self) -> dict:
        return {"type": self.type_name, "message": self.message}

    @staticmethod
    def from_dict(d: dict) -> "ExceptionInfo":
        return ExceptionInfo(d["type"], d["message"])
