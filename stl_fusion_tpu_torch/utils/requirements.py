"""Requirement — declarative value validation (src/Stl/Requirements/).

The reference models "this value must satisfy X or throw a well-known
error" as composable ``Requirement<T>`` objects: ``MustExistRequirement``
(non-null/default check), ``FuncRequirement`` (predicate + error factory),
combined via ``&``. Services use them as ``user.Require(User.MustExist)``.

Here a ``Requirement`` wraps a predicate and an error factory; ``check``
returns the value (for chaining) or raises. ``MUST_EXIST`` rejects ``None``
and empty strings/collections the way the reference's default-value check
rejects CLR defaults.
"""
from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")

__all__ = ["Requirement", "RequirementError", "MUST_EXIST", "must_exist"]


class RequirementError(ValueError):
    """Raised when a required condition does not hold."""


class Requirement(Generic[T]):
    def __init__(
        self,
        predicate: Callable[[T], bool],
        error_factory: Optional[Callable[[T], Exception]] = None,
        description: str = "requirement",
    ):
        self._predicate = predicate
        self._error_factory = error_factory or (
            lambda value: RequirementError(f"{description} failed for {value!r}")
        )
        self.description = description

    def is_satisfied(self, value: T) -> bool:
        try:
            return bool(self._predicate(value))
        except Exception:
            return False

    def check(self, value: T) -> T:
        """Return ``value`` if the requirement holds, else raise."""
        if not self.is_satisfied(value):
            raise self._error_factory(value)
        return value

    def with_error(self, error_factory: Callable[[T], Exception]) -> "Requirement[T]":
        return Requirement(self._predicate, error_factory, self.description)

    def __and__(self, other: "Requirement[T]") -> "Requirement[T]":
        def both(value: T) -> T:
            self.check(value)
            other.check(value)
            return value

        combined: Requirement[T] = Requirement(
            lambda v: self.is_satisfied(v) and other.is_satisfied(v),
            description=f"{self.description} & {other.description}",
        )

        def _raise(value: T) -> Exception:
            try:
                both(value)
            except Exception as e:  # noqa: BLE001 — re-raise whichever side failed
                return e
            return RequirementError(combined.description)

        return combined.with_error(_raise)


def _exists(value: object) -> bool:
    if value is None:
        return False
    try:
        size = len(value)  # type: ignore[arg-type]
    except TypeError:
        return True  # numbers, objects — any non-None scalar exists
    return size > 0  # empty str/bytes/list/dict/set are "missing"


MUST_EXIST: Requirement = Requirement(_exists, description="must exist")


def must_exist(value: Optional[T], what: str = "value") -> T:
    """Shorthand for ``MUST_EXIST.check`` with a named error message."""
    if not _exists(value):
        raise RequirementError(f"{what} is required but missing")
    return value  # type: ignore[return-value]
