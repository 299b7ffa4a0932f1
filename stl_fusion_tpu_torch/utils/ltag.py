"""LTag — compact int64 version tags for computed nodes.

Re-expression of the reference's ``LTag`` (src/Stl/LTag.cs:14-58) and
``LTagVersionGenerator`` (src/Stl/Versioning/Providers/LTagVersionGenerator.cs:5-21).
A version is a non-zero int64 rendered base-62 with an ``@`` prefix. The
generator never hands out the version it was asked to move past (the
"never repeats current" rule) so an invalidated node can always be told
apart from its recomputed successor.

On the TPU side versions live as an ``int32``/``int64`` lane in the CSR
mirror (see stl_fusion_tpu.graph), so LTag stays a plain int subclass —
zero-copy into jnp arrays.
"""
from __future__ import annotations

import itertools
import random
import time
from typing import Optional

__all__ = ["LTag", "VersionGenerator", "LTagVersionGenerator", "ClockBasedVersionGenerator"]

_BASE62 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_INT64_MASK = (1 << 63) - 1  # keep versions positive int64 for device arrays


class LTag(int):
    """Non-zero int64 version tag; ``LTag(0)`` is the "no version" sentinel."""

    __slots__ = ()

    @property
    def is_none(self) -> bool:
        return int(self) == 0

    def format(self) -> str:
        n = int(self)
        if n == 0:
            return "@0"
        digits = []
        while n:
            n, r = divmod(n, 62)
            digits.append(_BASE62[r])
        return "@" + "".join(reversed(digits))

    @staticmethod
    def parse(s: str) -> "LTag":
        if not s or s[0] != "@":
            raise ValueError(f"invalid LTag literal: {s!r}")
        n = 0
        for ch in s[1:]:
            n = n * 62 + _BASE62.index(ch)
        return LTag(n)

    def __repr__(self) -> str:
        return self.format()

    __str__ = __repr__


LTag.NONE = LTag(0)  # type: ignore[attr-defined]


class VersionGenerator:
    """Abstract version source."""

    def next(self, current: Optional[LTag] = None) -> LTag:
        raise NotImplementedError


class LTagVersionGenerator(VersionGenerator):
    """Monotonic counter from a random origin; never returns `current` or 0.

    CPython's itertools.count is GIL-atomic, giving a lock-free thread-safe
    source (the reference uses an interlocked increment).
    """

    __slots__ = ("_counter",)

    def __init__(self, seed: Optional[int] = None):
        rng = random.Random(seed)
        start = rng.getrandbits(62) | 1
        self._counter = itertools.count(start)

    def next(self, current: Optional[LTag] = None) -> LTag:
        while True:
            v = LTag(next(self._counter) & _INT64_MASK)
            if v != 0 and (current is None or v != current):
                return v


class ClockBasedVersionGenerator(VersionGenerator):
    """Versions from a nanosecond clock; strictly increasing, never `current`.

    Mirrors src/Stl/Versioning/Providers/ClockBasedVersionGenerator.cs.
    """

    __slots__ = ("_last",)

    def __init__(self):
        self._last = 0

    def next(self, current: Optional[LTag] = None) -> LTag:
        v = time.time_ns() & _INT64_MASK
        if v <= self._last:
            v = self._last + 1
        if current is not None and v == int(current):
            v += 1
        self._last = v
        return LTag(v)
