"""ChaosPolicy — seeded, deterministic fault injection for the RPC fabric.

Two injection points, one policy object:

- **Twisted test channels** (``rpc/testing.py``): :func:`wrap_chaos_pair`
  wraps a ``ChannelPair`` endpoint so every ``send`` samples the policy.
  A *drop* models real packet loss on a reliable transport: the frame is
  lost AND the link is declared dead (pair closed + ``ChannelClosedError``
  raised at the sender) — exactly the unacked-frame-kills-the-TCP-session
  shape the reconnect/re-send machinery is built to absorb. Duplicates,
  delays, and reordering are delivered non-fatally (dedup + retry logic
  must absorb them on a live link).
- **Real middleware stage** (``rpc/middleware.py`` re-exports
  :func:`chaos_middleware`): drops are silent swallows, duplicates call the
  chain twice, delays sleep — the production-shaped injection for staging
  hubs (no test transport required).

Timed faults (partition windows, peer-kill schedules) live on the policy
too; :class:`ChaosScenarioRunner` replays them against a test transport on
a wall clock, so a named scenario is a complete, reproducible fault script.
All randomness flows from one ``random.Random(seed)`` — same seed, same
fault sequence.
"""
from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.async_utils import ChannelClosedError
from .events import ResilienceEvents, global_events

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "ChaosActions",
    "ChaosPolicy",
    "ChaosScenarioRunner",
    "SCENARIOS",
    "chaos_middleware",
    "wrap_chaos_pair",
]


@dataclass(frozen=True)
class ChaosActions:
    """One message's sampled fate."""

    drop: bool = False
    duplicate: bool = False
    delay_s: float = 0.0


@dataclass
class ChaosPolicy:
    """Deterministic per-message fault probabilities + timed fault script.

    ``partitions`` are ``(at_s, duration_s)`` offsets from scenario start;
    ``peer_kills`` are ``(at_s, peer_ref)``. Both are enacted by
    :class:`ChaosScenarioRunner`; the per-message probabilities apply
    wherever the policy is plugged in (channel wrapper or middleware).
    ``wave_faults`` names offsets at which the runner injects a device-wave
    fault into an attached :class:`~stl_fusion_tpu_torch.resilience.WaveWatchdog`.
    """

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_range_s: Tuple[float, float] = (0.001, 0.01)
    reorder_window: int = 0  # ≥2 buffers that many frames and shuffles
    reorder_flush_s: float = 0.02  # partial buffers flush after this long
    partitions: List[Tuple[float, float]] = field(default_factory=list)
    peer_kills: List[Tuple[float, str]] = field(default_factory=list)
    wave_faults: List[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self.messages_seen = 0
        self.dropped = 0
        self.duplicated = 0
        self.delayed = 0
        self.reordered = 0

    def sample(self) -> ChaosActions:
        """One draw per message — the policy's single randomness stream."""
        rng = self._rng
        self.messages_seen += 1
        if self.drop and rng.random() < self.drop:
            self.dropped += 1
            return ChaosActions(drop=True)
        duplicate = bool(self.duplicate and rng.random() < self.duplicate)
        delay_s = 0.0
        if self.delay and rng.random() < self.delay:
            delay_s = rng.uniform(*self.delay_range_s)
            self.delayed += 1
        if duplicate:
            self.duplicated += 1
        return ChaosActions(duplicate=duplicate, delay_s=delay_s)

    def shuffle(self, items: list) -> None:
        self._rng.shuffle(items)


class _ChaosWriter:
    """Chaos-applying writer half of a wrapped endpoint. Reordering buffers
    up to ``reorder_window`` frames and releases them shuffled; a flush
    timer bounds how long a partial buffer can hold a frame (a held-forever
    invalidation would read as a lost one)."""

    def __init__(self, wrapper: "_ChaosPair", policy: ChaosPolicy, events: ResilienceEvents):
        self._wrapper = wrapper
        self._policy = policy
        self._events = events
        self._buffer: list = []
        self._flush_task: Optional[asyncio.Task] = None

    async def send(self, message) -> None:
        act = self._policy.sample()
        if act.drop:
            # frame lost ⇒ link dead (the reliable-transport contract: loss
            # surfaces as connection death, never as a silent gap)
            self._events.record("chaos_drop")
            err = ChannelClosedError("chaos: frame dropped, link torn down")
            self._wrapper.close(err)
            raise err
        if act.delay_s > 0:
            self._wrapper.spawn(self._deliver_later(message, act.delay_s))
        else:
            await self._enqueue(message)
        if act.duplicate:
            await self._enqueue(message)

    async def _deliver_later(self, message, delay_s: float) -> None:
        await asyncio.sleep(delay_s)
        await self._enqueue(message)

    async def _enqueue(self, message) -> None:
        if self._policy.reorder_window >= 2:
            self._buffer.append(message)
            if len(self._buffer) >= self._policy.reorder_window:
                await self._flush()
            elif self._flush_task is None or self._flush_task.done():
                self._flush_task = self._wrapper.spawn(self._flush_after())
        else:
            await self._deliver(message)

    async def _flush_after(self) -> None:
        await asyncio.sleep(self._policy.reorder_flush_s)
        await self._flush()

    async def _flush(self) -> None:
        batch, self._buffer = self._buffer, []
        if len(batch) > 1:
            self._policy.shuffle(batch)
            self._policy.reordered += len(batch)
        for m in batch:
            await self._deliver(m)

    async def _deliver(self, message) -> None:
        try:
            await self._wrapper._pair.writer.send(message)
        except ChannelClosedError:
            pass  # link already died; the frame is lost with it — standard recovery


class _ChaosPair:
    """ChannelPair wrapper: chaos on the write side, passthrough reads."""

    def __init__(self, pair, policy: ChaosPolicy, events: ResilienceEvents):
        self._pair = pair
        self.reader = pair.reader
        self.writer = _ChaosWriter(self, policy, events)
        self._tasks: set = set()

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def close(self, error: Optional[BaseException] = None) -> None:
        for t in list(self._tasks):
            t.cancel()
        self._pair.close(error)


def wrap_chaos_pair(pair, policy: ChaosPolicy, events: Optional[ResilienceEvents] = None):
    """Wrap one endpoint of a twisted channel pair with chaos on sends."""
    return _ChaosPair(pair, policy, events if events is not None else global_events())


def chaos_middleware(policy: ChaosPolicy, events: Optional[ResilienceEvents] = None):
    """The production-shaped injection point: a middleware stage for
    ``RpcHub.inbound_middlewares`` / ``outbound_middlewares``. Unlike the
    channel wrapper, a middleware drop is a SILENT swallow (the message
    evaporates between transport and dispatch) — it exercises the layers
    above against loss without killing the link, the staging-hub shape."""
    ev = events if events is not None else global_events()

    async def middleware(peer, message, nxt):
        act = policy.sample()
        if act.drop:
            ev.record("chaos_drop", f"{message.service}.{message.method}")
            return
        if act.delay_s > 0:
            await asyncio.sleep(act.delay_s)
        await nxt(message)
        if act.duplicate:
            await nxt(message)

    return middleware


class ChaosScenarioRunner:
    """Replays a policy's timed fault script against a live test transport.

    ``await run()`` drives the whole script on the wall clock: partitions
    (block reconnects + drop the link, then unblock), peer kills (drop the
    link, auto-reconnect), and wave-fault injections into an attached
    watchdog. Message-level chaos is already live the moment the policy is
    installed on the transport — the runner only owns the timed events.
    """

    def __init__(self, transport, policy: ChaosPolicy, peer_ref: str = "default",
                 watchdog=None, events: Optional[ResilienceEvents] = None):
        self.transport = transport
        self.policy = policy
        self.peer_ref = peer_ref
        self.watchdog = watchdog
        self.events = events if events is not None else global_events()

    async def run(self) -> None:
        script = (
            [(at, "partition", dur) for at, dur in self.policy.partitions]
            + [(at, "kill", ref) for at, ref in self.policy.peer_kills]
            + [(at, "wave_fault", None) for at in self.policy.wave_faults]
        )
        script.sort(key=lambda e: e[0])
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        for at, kind, arg in script:
            wait = t0 + at - loop.time()
            if wait > 0:
                await asyncio.sleep(wait)
            if kind == "partition":
                self.events.record("chaos_partition", f"{arg}s")
                self.transport.block_reconnects(True)
                await self.transport.disconnect(self.peer_ref)
                await asyncio.sleep(arg)
                self.transport.block_reconnects(False)
            elif kind == "kill":
                self.events.record("chaos_peer_kill", arg)
                await self.transport.disconnect(arg)
            elif kind == "wave_fault" and self.watchdog is not None:
                self.events.record("chaos_wave_fault")
                self.watchdog.inject_fault_next()


#: named, reusable fault scripts (RESILIENCE.md documents each); scenarios
#: are factories so every run gets a fresh rng stream from the same seed
SCENARIOS: Dict[str, Callable[..., ChaosPolicy]] = {}


def _scenario(name: str):
    def register(fn):
        SCENARIOS[name] = fn
        return fn

    return register


@_scenario("flaky_link")
def flaky_link(seed: int = 17) -> ChaosPolicy:
    """Lossy link, no scheduled events: 5% frame loss (each killing the
    link), light duplication — the pure reconnect/re-send storm shape."""
    return ChaosPolicy(seed=seed, drop=0.05, duplicate=0.02)


@_scenario("reorder_burst")
def reorder_burst(seed: int = 23) -> ChaosPolicy:
    """No loss, heavy reordering + duplication: exercises result-vs-
    invalidate races and inbound dedup without ever dropping the link."""
    return ChaosPolicy(seed=seed, duplicate=0.05, reorder_window=4)


@_scenario("member_churn")
def member_churn(seed: int = 41) -> ChaosPolicy:
    """Lossy, duplicating, reordering links with NO scheduled events — the
    message-level weather for the cluster acceptance scenario
    (tests/test_cluster.py): the kill/join sequence is orchestrated by the
    test (real member death, not a link flap), while every control-plane
    and data frame rides this policy."""
    return ChaosPolicy(seed=seed, drop=0.03, duplicate=0.02, reorder_window=4)


@_scenario("rolling_restart")
def rolling_restart(seed: int = 53) -> ChaosPolicy:
    """Message-level weather for the rolling-upgrade acceptance scenario
    (tests/test_cluster.py): each of the 3 members is killed and
    warm-rejoined from its durable snapshot IN SEQUENCE while every frame
    — heartbeats, map gossip, ``$sys-c`` pushes, rejoin traffic — rides a
    lossy, duplicating, reordering link. Like ``member_churn``, the
    kill/restart sequence itself is orchestrated by the test (real member
    death + restore-from-snapshot, not a link flap)."""
    return ChaosPolicy(seed=seed, drop=0.03, duplicate=0.02, reorder_window=4)


@_scenario("host_kill_reform")
def host_kill_reform(seed: int = 61) -> ChaosPolicy:
    """Mesh-layer weather for the host-death leg: one scheduled
    peer kill on a lossy link. The HOST kill itself (SIGKILL of a whole
    emulated-host process, evidence convergence, in-process degrade →
    re-form) is orchestrated by the harness (perf/mesh_multihost.py and
    tests/test_mesh_controller.py); this policy supplies the DCN frame
    weather riding under it, so detection converges from noisy evidence,
    not a clean silence."""
    return ChaosPolicy(
        seed=seed,
        drop=0.03,
        duplicate=0.02,
        reorder_window=4,
        peer_kills=[(0.2, "default")],
    )


@_scenario("host_flap")
def host_flap(seed: int = 67) -> ChaosPolicy:
    """Host flap: kill + fast rejoin under an open breaker.
    Two quick peer kills (the ramp that opens the breaker) and NO partition
    — the harness kills the host process right after, then relaunches it as
    a live JOINer while the survivor's breaker is still open. Certifies
    that a flapping host is absorbed via the counted degrade → re-form →
    join path with zero divergent waves, never a survivor restart."""
    return ChaosPolicy(
        seed=seed,
        drop=0.03,
        duplicate=0.02,
        reorder_window=4,
        peer_kills=[(0.1, "default"), (0.25, "default")],
    )


@_scenario("mesh_partition")
def mesh_partition(seed: int = 71) -> ChaosPolicy:
    """DCN partition between live hosts: a 1.5s full partition
    on a lossy link, no kills. The mesh controller must RIDE THIS OUT —
    a lone heartbeat lapse is single-source evidence, below the
    convergence threshold, so no eviction and no degrade; the window
    closes and waves stay oracle-exact."""
    return ChaosPolicy(
        seed=seed,
        drop=0.03,
        duplicate=0.02,
        reorder_window=4,
        partitions=[(0.2, 1.5)],
    )


@_scenario("partition_storm")
def partition_storm(seed: int = 31) -> ChaosPolicy:
    """Three quick peer kills (the flap ramp that opens a breaker), then a
    2-second full partition, on top of a lossy reordered link — the
    acceptance scenario of tests/test_resilience.py, with one wave fault
    injected mid-partition."""
    return ChaosPolicy(
        seed=seed,
        drop=0.05,
        duplicate=0.02,
        reorder_window=4,
        peer_kills=[(0.15, "default"), (0.3, "default"), (0.45, "default")],
        partitions=[(0.7, 2.0)],
        wave_faults=[0.8],
    )
