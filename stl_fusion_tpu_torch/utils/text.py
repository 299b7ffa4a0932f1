"""Symbol — interned string identity (src/Stl/Text/Symbol.cs).

The reference's ``Symbol`` is a struct wrapping a string with a cached hash
so dictionary keys (service names, method names, peer keys) compare by
reference after interning. CPython caches ``str.__hash__``; ``Symbol`` adds
identity interning for arbitrary strings (weak table, so dynamic symbols
don't pin memory) plus value semantics matching the reference (empty
symbol, truthiness, ordering).
"""
from __future__ import annotations

import weakref

__all__ = ["Symbol"]


class Symbol(str):
    """Interned string with value semantics; ``Symbol('') == Symbol.EMPTY``.
    Construction interns: ``Symbol(x) is Symbol(x)`` for equal inputs, so
    symbol comparisons in hot maps are pointer checks. The intern table
    holds weak references — dynamic symbols (per-session keys) are
    collectable once unreferenced."""

    __slots__ = ("__weakref__",)

    EMPTY: "Symbol"
    _interned: "weakref.WeakValueDictionary[str, Symbol]" = weakref.WeakValueDictionary()

    def __new__(cls, value: object = "") -> "Symbol":
        if isinstance(value, Symbol):
            return value
        s = str(value)
        sym = cls._interned.get(s)
        if sym is None:
            sym = super().__new__(cls, s)
            cls._interned[s] = sym
        return sym

    @property
    def value(self) -> str:
        return str(self)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def __repr__(self) -> str:
        return f"Symbol({str.__repr__(self)})"


Symbol.EMPTY = Symbol("")
