"""Result[T] — value-or-error union.

TPU-native re-expression of the reference's ``Result<T>`` (src/Stl/Result.cs):
an immutable pair ``(value, error)`` where exactly one side is meaningful.
Computed nodes store their output as a Result so errors are memoized and
propagated through the dependency graph the same way values are.
"""
from __future__ import annotations

from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = ["Result", "ok", "error"]


class Result(Generic[T]):
    """Immutable value-or-error union."""

    __slots__ = ("_value", "_error")

    def __init__(self, value: Optional[T] = None, error: Optional[BaseException] = None):
        self._value = value
        self._error = error

    # -- constructors ------------------------------------------------------
    @staticmethod
    def ok(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def err(exc: BaseException) -> "Result[Any]":
        if exc is None:
            raise ValueError("error must not be None")
        return Result(error=exc)

    @staticmethod
    def capture(fn: Callable[[], T]) -> "Result[T]":
        try:
            return Result.ok(fn())
        except Exception as e:  # noqa: BLE001 - memoize any error
            return Result.err(e)

    # -- accessors ---------------------------------------------------------
    @property
    def has_value(self) -> bool:
        return self._error is None

    @property
    def has_error(self) -> bool:
        return self._error is not None

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def value(self) -> T:
        """Return the value, raising the stored error if there is one."""
        if self._error is not None:
            raise self._error
        return self._value  # type: ignore[return-value]

    @property
    def value_or_default(self) -> Optional[T]:
        return None if self._error is not None else self._value

    def unwrap(self) -> T:
        return self.value

    # -- combinators -------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "Result[U]":
        if self._error is not None:
            return Result(error=self._error)
        return Result.capture(lambda: fn(self._value))  # type: ignore[arg-type]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Result):
            return NotImplemented
        if self.has_error != other.has_error:
            return False
        if self.has_error:
            # errors compare by type + args (exceptions aren't value-comparable)
            return (
                type(self._error) is type(other._error)
                and self._error.args == other._error.args  # type: ignore[union-attr]
            )
        return self._value == other._value

    def __hash__(self) -> int:
        if self.has_error:
            return hash((type(self._error), self._error.args))  # type: ignore[union-attr]
        try:
            return hash(self._value)
        except TypeError:
            return hash(id(self._value))

    def __repr__(self) -> str:
        if self.has_error:
            return f"Result.err({self._error!r})"
        return f"Result.ok({self._value!r})"


def ok(value: T) -> Result[T]:
    return Result.ok(value)


def error(exc: BaseException) -> Result[Any]:
    return Result.err(exc)
