"""Concurrency helpers (src/Stl/Concurrency/).

``StochasticCounter`` (Concurrency/StochasticCounter.cs) — an approximate
event counter that only pays for an atomic increment on a random 1-in-2^k
sample of calls. The reference's ComputedRegistry uses it to trigger pruning
"roughly every N operations" without a contended counter. Under the GIL a
plain int increment is cheap, but the *sampling* contract still matters: the
registry analogue here asks ``increment()`` and gets back a sampled
approximate total (or None when the call wasn't sampled), so prune cadence
matches the reference's stochastic behavior.
"""
from __future__ import annotations

import random
from typing import Optional

__all__ = ["StochasticCounter"]


class StochasticCounter:
    def __init__(self, sample_period_log2: int = 4, rng: Optional[random.Random] = None):
        if not 0 <= sample_period_log2 <= 30:
            raise ValueError("sample_period_log2 must be in [0, 30]")
        self.sample_period = 1 << sample_period_log2
        self._mask = self.sample_period - 1
        self._rng = rng or random.Random()
        self._value = 0

    @property
    def approximate_value(self) -> int:
        return self._value

    @approximate_value.setter
    def approximate_value(self, value: int) -> None:
        self._value = value

    def increment(self) -> Optional[int]:
        """Sampled increment: returns the new approximate total on sampled
        calls (1 in sample_period), None otherwise."""
        if self._rng.getrandbits(32) & self._mask:
            return None
        self._value += self.sample_period
        return self._value

    def decrement(self) -> Optional[int]:
        if self._rng.getrandbits(32) & self._mask:
            return None
        self._value = max(0, self._value - self.sample_period)
        return self._value

    def reset(self) -> None:
        self._value = 0
