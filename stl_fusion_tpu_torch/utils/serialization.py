"""Wire serialization: tagged JSON with a type registry.

Re-expression of the reference's serialization stack
(src/Stl/Serialization/ — TextOrBytes, MemoryPack/JSON dual serializers;
src/Stl.Rpc/Configuration/RpcByteArgumentSerializer.cs:8-60). The reference
writes each argument with a polymorphic type prefix; here every non-primitive
value is encoded as ``{"$t": <registered name>, ...fields}``. Dataclasses
register via ``@wire_type``; primitives, lists, dicts, bytes (base64),
LTag, and ExceptionInfo are built in.

JSON keeps the protocol debuggable and host-portable; the payload rides as
UTF-8 bytes (TextOrBytes ≈ ``bytes`` here). A binary codec can be swapped in
per-peer the way the reference swaps MemoryPack for JSON.
"""
from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple, Type, TypeVar

from .errors import ExceptionInfo
from .ltag import LTag

T = TypeVar("T")

__all__ = [
    "wire_type",
    "register_wire_type",
    "encode",
    "decode",
    "dumps",
    "loads",
    "deep_tuple",
    "WireSerializer",
]


def deep_tuple(v):
    """Wire decode turns tuples into lists (JSON has no tuple); values used
    as cache/codec keys or replayed method args must re-tuple DEEPLY to be
    hashable again. THE shared helper — remote-table keys, checkpoint codec
    keys, KwArgsTail restore and explain-request args all decode through
    this one definition."""
    return tuple(deep_tuple(x) for x in v) if isinstance(v, list) else v

_BY_NAME: Dict[str, Tuple[Type, Callable[[Any], dict], Callable[[dict], Any]]] = {}
_BY_TYPE: Dict[Type, str] = {}


def register_wire_type(
    cls: Type[T],
    name: Optional[str] = None,
    to_dict: Optional[Callable[[T], dict]] = None,
    from_dict: Optional[Callable[[dict], T]] = None,
) -> Type[T]:
    n = name or cls.__name__
    if to_dict is None:
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls} needs explicit to_dict/from_dict (not a dataclass)")
        fields = [f.name for f in dataclasses.fields(cls)]
        to_dict = lambda obj: {f: getattr(obj, f) for f in fields}  # noqa: E731
        from_dict = lambda d: cls(**d)  # noqa: E731
    _BY_NAME[n] = (cls, to_dict, from_dict)  # type: ignore[arg-type]
    _BY_TYPE[cls] = n
    return cls


def wire_type(name: Optional[str] = None):
    """Class decorator registering a dataclass for wire transport."""

    def deco(cls: Type[T]) -> Type[T]:
        return register_wire_type(cls, name if isinstance(name, str) else None)

    if isinstance(name, type):  # bare @wire_type
        cls, name = name, None
        return register_wire_type(cls)
    return deco


register_wire_type(
    ExceptionInfo, "ExceptionInfo", lambda e: e.to_dict(), lambda d: ExceptionInfo.from_dict(d)
)
register_wire_type(LTag, "LTag", lambda v: {"v": int(v)}, lambda d: LTag(d["v"]))


def _register_ndarray() -> None:
    """numpy arrays travel as raw bytes + dtype + shape (the batch-read
    payload shape — a JSON float list would dominate the wire cost of the
    vectorized read path)."""
    import numpy as np

    register_wire_type(
        np.ndarray,
        "ndarray",
        to_dict=lambda a: {
            "data": a.tobytes(),
            "dtype": str(a.dtype),
            "shape": list(a.shape),
        },
        from_dict=lambda d: np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
        .reshape(d["shape"])
        .copy(),
    )


_register_ndarray()


def encode(value: Any) -> Any:
    """Value → JSON-compatible structure with $t tags."""
    if value is None or isinstance(value, (bool, int, float, str)):
        if isinstance(value, int) and type(value) is not int and type(value) is not bool:
            # int subclass (e.g. LTag) — fall through to registered encoding
            pass
        else:
            return value
    t = type(value)
    if t in (list, tuple):
        return [encode(v) for v in value]
    if t is dict:
        return {"$t": "dict", "items": [[encode(k), encode(v)] for k, v in value.items()]}
    if t in (bytes, bytearray, memoryview):
        return {"$t": "bytes", "b64": base64.b64encode(bytes(value)).decode("ascii")}
    name = _BY_TYPE.get(t)
    if name is None:
        for base, n in _BY_TYPE.items():
            if isinstance(value, base):
                name = n
                break
    if name is None:
        raise TypeError(f"type {t.__name__} is not wire-registered; use @wire_type")
    _, to_dict, _ = _BY_NAME[name]
    return {"$t": name, "d": {k: encode(v) for k, v in to_dict(value).items()}}


def decode(data: Any) -> Any:
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [decode(v) for v in data]
    if isinstance(data, dict):
        tag = data.get("$t")
        if tag == "dict":
            return {_hashable(decode(k)): decode(v) for k, v in data["items"]}
        if tag == "bytes":
            return base64.b64decode(data["b64"])
        if tag is None:
            return {k: decode(v) for k, v in data.items()}
        entry = _BY_NAME.get(tag)
        if entry is None:
            raise TypeError(f"unknown wire type {tag!r}")
        _, _, from_dict = entry
        return from_dict({k: decode(v) for k, v in data["d"].items()})
    raise TypeError(f"cannot decode {type(data).__name__}")


def _hashable(v: Any) -> Any:
    return tuple(v) if isinstance(v, list) else v


def dumps(value: Any) -> bytes:
    return json.dumps(encode(value), separators=(",", ":")).encode("utf-8")


def loads(data: bytes) -> Any:
    return decode(json.loads(data.decode("utf-8")))


class WireSerializer:
    """Pluggable serializer facade (per-peer swappable, like the reference)."""

    def dumps(self, value: Any) -> bytes:
        return dumps(value)

    def loads(self, data: bytes) -> Any:
        return loads(data)
