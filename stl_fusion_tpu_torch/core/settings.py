"""FusionSettings — global tuning derived from the host's CPU count.

Re-expression of src/Stl.Fusion/FusionSettings.cs:5-50: registry sizing uses
prime-adjacent capacities (fewer hash collisions), timer and pruner batch
sizes scale with a rounded-up power-of-two of the core count, and a
client/server mode flag picks smaller client-side defaults. Components read
these at construction; tests override the module-level ``settings``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = ["FusionMode", "FusionSettings", "settings"]


def _cpu_po2() -> int:
    n = os.cpu_count() or 1
    p = 1
    while p < n:
        p <<= 1
    return p


def _next_prime(n: int) -> int:
    def is_prime(x: int) -> bool:
        if x < 2:
            return False
        f = 2
        while f * f <= x:
            if x % f == 0:
                return False
            f += 1
        return True

    while not is_prime(n):
        n += 1
    return n


class FusionMode:
    SERVER = "server"
    CLIENT = "client"


@dataclass
class FusionSettings:
    mode: str = FusionMode.SERVER
    cpu_po2: int = field(default_factory=_cpu_po2)

    @property
    def registry_concurrency(self) -> int:
        """Lock striping level for the computed registry (prime-sized)."""
        return _next_prime(self.cpu_po2)

    @property
    def registry_capacity(self) -> int:
        """Initial registry capacity: prime near 512 (client) / 8k (server)
        per core-po2, matching the reference's client/server split."""
        base = 509 if self.mode == FusionMode.CLIENT else 8179
        return _next_prime(base * max(self.cpu_po2 // 4, 1))

    @property
    def timer_quanta(self) -> float:
        """Shared timer-wheel tick. The reference uses 0.2s quanta
        (Internal/Timeouts.cs); this build defaults finer — asyncio timers
        are cheap and sub-100ms invalidation delays are common in tests."""
        return 0.05

    @property
    def timer_concurrency(self) -> int:
        return max(self.cpu_po2 // 2, 1)

    @property
    def pruner_batch_size(self) -> int:
        return self.cpu_po2 * 512


settings = FusionSettings()
