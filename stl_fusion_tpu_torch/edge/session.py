"""Edge session core — bounded outboxes, latest-wins coalescing, eviction.

The per-connection delivery machinery every downstream surface shares:
the edge gateway's SSE/WebSocket sessions and the UI
layer's ``LiveViewServer`` pump both ride these pieces, so backpressure,
heartbeat keep-alives and slow-consumer eviction behave identically no
matter which transport a browser arrived on.

Three pieces, smallest first:

- :class:`LatestWinsMailbox` — the single-slot render mailbox (formerly
  ``ui.web._RenderSlot``): a payload that lands while an older one is still
  pending REPLACES it, so a stalled reader holds ONE pending payload no
  matter how many renders fire.
- :class:`KeyedMailbox` — the multi-key variant the edge needs: pending
  frames coalesce PER KEY (a key fenced five times between drains ships
  once, at the newest value), preserving first-arrival order across keys.
  Bounded: a mailbox that exceeds ``max_pending`` distinct keys reports
  overflow, which the owner treats as a slow consumer (evict + resume
  token) — pending memory per session is therefore bounded by
  min(subscribed keys, max_pending) frames, never by event rate.
- :func:`pump_payloads` — the shared per-connection pump: take latest-wins
  payloads, optionally rate-limit (the newest payload at the end of the
  interval is what ships), send with a timeout, heartbeat when idle, and
  EVICT the connection when a send cannot make progress — a dead tab never
  pins its session, and (each session having its own pump) never stalls a
  sibling.

:class:`EdgeSession` is the gateway's per-subscriber state: identity
(resume token), subscribed keys, delivered-version map (the Last-Event-ID
resume source) and a delivery surface that is either a synchronous sink
(in-process consumers, the 1M-subscriber simulation) or a
:class:`KeyedMailbox` drained by a transport pump (SSE/WebSocket).

Frames are plain tuples — ``(key, version, value, cause, origin_ts, err)``
— so a million in flight stay cheap; :func:`frame_to_dict` is the wire
shape. ``cause``/``origin_ts`` ride through from the upstream ``$sys-c``
fence (ClientComputed.invalidation_cause/_origin_ts), so the delivery
histogram measures server wave apply → client-visible and ``explain()``
can span server wave → edge → session.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import os
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

__all__ = [
    "EdgeSession",
    "EncodedFrame",
    "Frame",
    "KeyedMailbox",
    "LatestWinsMailbox",
    "frame_to_dict",
    "pump_payloads",
]

#: (key, version, value, cause, origin_ts, err) — err is a "Type: msg"
#: string when the upstream read failed, else None
Frame = Tuple[str, int, Any, Optional[str], Optional[float], Optional[str]]


def frame_to_dict(frame: Frame) -> dict:
    """The JSON wire shape of one frame (SSE ``data:`` payload / WS
    message). ``cause`` + ``t0`` propagate the upstream fence identity so a
    downstream consumer can extend the causal chain and the delivery
    measurement one more hop."""
    key, version, value, cause, origin_ts, err = frame
    out: dict = {"key": key, "ver": version}
    if err is not None:
        out["err"] = err
    else:
        out["value"] = value
    if cause is not None:
        out["cause"] = cause
    if origin_ts is not None:
        out["t0"] = origin_ts
    return out


class EncodedFrame:
    """One frame's wire payload, serialized EXACTLY ONCE.

    The fan path used to pay ``json.dumps(frame_to_dict(frame))`` per
    session per frame — a 250k-session hot key re-encoded the same JSON
    250k times. An :class:`EncodedFrame` is minted once per (key,
    version) and every downstream pump writes the same immutable
    ``bytes``; only the per-session envelope (the SSE ``id:`` line — the
    resume token) stays per-session, written as a cheap prefix around the
    shared body.

    ``body`` is the canonical JSON object bytes (compact separators — the
    wire shape of :func:`frame_to_dict`). ``sse`` is the shared SSE tail
    (``event: update\\ndata: <body>\\n\\n``); a transport prepends its
    session's ``id: <token>\\n`` line. ``text`` is the lazily-decoded str
    for WebSocket text frames (decoded at most once per encoded frame,
    and only when a WS session exists).

    ``lossy`` latches when the payload was not JSON-serializable and fell
    back to ``repr`` — detected HERE, at encode time, once per frame
    (counted by the node as ``fusion_edge_frames_lossy_total``) instead
    of silently repr-ing per session inside the old per-delivery dumps.

    Immutability contract: the bytes are built from the payload at encode
    time — a caller that mutates the payload dict afterwards changes
    nothing a session will see (regression-tested).
    """

    __slots__ = (
        "key", "version", "body", "sse", "lossy", "has_t0",
        "replay_variant", "_text",
    )

    def __init__(self, frame: Frame):
        self.key = frame[0]
        self.version = frame[1]
        #: whether the body carries the fence origin timestamp. Replays
        #: (attach/resume/reconnect) ship WITHOUT it — now-minus-then is a
        #: reconnect gap, not delivery latency — so a replay asks for the
        #: t0-stripped twin, cached as :attr:`replay_variant` on the
        #: canonical entry (still one encode per variant, ever).
        self.has_t0 = frame[4] is not None
        self.replay_variant: Optional["EncodedFrame"] = None
        payload = frame_to_dict(frame)
        try:
            body = json.dumps(payload, separators=(",", ":")).encode()
            self.lossy = False
        except (TypeError, ValueError):
            body = json.dumps(
                payload, separators=(",", ":"), default=repr
            ).encode()
            self.lossy = True
        self.body = body
        self.sse = b"event: update\ndata: " + body + b"\n\n"
        self._text: Optional[str] = None

    @property
    def text(self) -> str:
        """The body as str (WS text frames) — decoded at most once."""
        if self._text is None:
            self._text = self.body.decode()
        return self._text

    def sse_event(self, id_prefix: bytes) -> bytes:
        """The full per-session SSE event: the session's ``id:`` prefix
        (its resume token envelope) + the SHARED tail bytes."""
        return id_prefix + self.sse


class LatestWinsMailbox:
    """Latest-wins render mailbox (one per connection): a payload that
    lands while an older one is still pending simply REPLACES it — the
    Blazor render-current-state rule (ComputedStateComponent.cs:27-132). A
    stalled reader therefore holds ONE pending payload no matter how many
    invalidations fire; intermediate payloads nobody could have seen are
    dropped, counted in ``coalesced``."""

    _EMPTY = object()
    __slots__ = ("_payload", "_event", "pushed", "coalesced")

    def __init__(self):
        self._payload: Any = self._EMPTY
        self._event = asyncio.Event()
        self.pushed = 0
        self.coalesced = 0

    def push(self, payload: Any) -> None:
        if self._payload is not self._EMPTY:
            self.coalesced += 1
        self._payload = payload
        self.pushed += 1
        self._event.set()

    async def take(self) -> Any:
        await self._event.wait()
        self._event.clear()
        payload, self._payload = self._payload, self._EMPTY
        return payload

    def take_nowait(self, default: Any) -> Any:
        """The newest payload if one landed since, else ``default`` (used
        after a rate-limit sleep so the send is never stale)."""
        if self._payload is self._EMPTY:
            return default
        self._event.clear()
        payload, self._payload = self._payload, self._EMPTY
        return payload


class KeyedMailbox:
    """Multi-key latest-wins mailbox: pending frames coalesce PER KEY
    (dict insertion order preserves cross-key arrival order), and a drain
    takes the whole pending batch. ``overflowed`` latches when more than
    ``max_pending`` distinct keys are pending at once — the owner's signal
    that this consumer is not draining (evict with a resume token; the
    per-key version map replays what it missed)."""

    __slots__ = ("_pending", "_event", "max_pending", "pushed", "coalesced", "overflowed")

    def __init__(self, max_pending: int = 4096):
        self._pending: Dict[str, Frame] = {}
        self._event = asyncio.Event()
        self.max_pending = max_pending
        self.pushed = 0
        self.coalesced = 0
        self.overflowed = False

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, frame: Frame) -> None:
        key = frame[0]
        if key in self._pending:
            self.coalesced += 1
        elif len(self._pending) >= self.max_pending:
            self.overflowed = True
        self._pending[key] = frame
        self.pushed += 1
        self._event.set()

    async def take(self) -> List[Frame]:
        while not self._pending:
            self._event.clear()
            await self._event.wait()
        self._event.clear()
        batch = list(self._pending.values())
        self._pending.clear()
        return batch

    def take_nowait(self, default: Any) -> Any:
        """Newest pending frames MERGED over ``default`` (the batch a
        rate-limited pump already took): latest-wins is per KEY here, so a
        taken frame whose key has no newer pending frame must still ship —
        wholesale replacement (the single-slot mailbox's semantics) would
        silently drop another key's only update."""
        if not self._pending:
            return default
        self._event.clear()
        merged: Dict[str, Frame] = {}
        if isinstance(default, list):
            for frame in default:
                merged[frame[0]] = frame
        for key, frame in self._pending.items():
            merged[key] = frame
        self._pending.clear()
        return list(merged.values())


async def pump_payloads(
    mailbox,
    send: Callable[[Any], Awaitable[None]],
    *,
    min_send_interval: float = 0.0,
    send_timeout: Optional[float] = None,
    heartbeat_interval: Optional[float] = None,
    heartbeat: Optional[Callable[[], Awaitable[None]]] = None,
    on_evict: Optional[Callable[[], None]] = None,
) -> str:
    """Drive one connection until it dies. Returns ``"evicted"`` when a
    send (or heartbeat) could not make progress for ``send_timeout``
    seconds — the caller's ``on_evict`` has already run — or ``"closed"``
    when the transport raised (a dying socket is a normal exit).

    Semantics shared by every downstream surface:

    - **latest-wins**: payloads come from ``mailbox.take()``; whatever
      coalescing the mailbox does is the backpressure story.
    - **rate limit**: with ``min_send_interval`` set, the pump sleeps out
      the remainder of the interval and then ships the NEWEST payload
      (``take_nowait`` supersedes the taken one) — a burst collapses to
      one frame per interval, never a stale one.
    - **heartbeat**: with ``heartbeat_interval`` set, an idle connection
      gets ``heartbeat()`` calls so proxies/browsers keep it open and a
      dead peer is detected by the send timeout instead of never.
    - **eviction**: a send that cannot complete within ``send_timeout``
      means the peer stopped draining; the pump runs ``on_evict`` (abort
      the transport, park the session) and exits. Each connection has its
      OWN pump, so one stalled peer never delays a sibling.
    """
    loop = asyncio.get_event_loop()
    last_send = -float("inf")
    while True:
        if heartbeat_interval is not None and heartbeat_interval > 0:
            try:
                payload = await asyncio.wait_for(mailbox.take(), heartbeat_interval)
            except (asyncio.TimeoutError, TimeoutError):
                if heartbeat is None:
                    continue
                try:
                    await asyncio.wait_for(heartbeat(), send_timeout)
                except (asyncio.TimeoutError, TimeoutError):
                    if on_evict is not None:
                        on_evict()
                    return "evicted"
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — dying socket: normal exit
                    return "closed"
                continue
        else:
            payload = await mailbox.take()
        if min_send_interval > 0:
            wait = min_send_interval - (loop.time() - last_send)
            if wait > 0:
                await asyncio.sleep(wait)
                payload = mailbox.take_nowait(payload)  # newest at send time
        try:
            await asyncio.wait_for(send(payload), send_timeout)
        except (asyncio.TimeoutError, TimeoutError):
            # the peer stopped draining: evict it rather than letting a
            # dead tab pin the session forever
            if on_evict is not None:
                on_evict()
            return "evicted"
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a dying socket is a normal exit
            return "closed"
        last_send = loop.time()


_token_counter = itertools.count(1)


def _mint_token() -> str:
    """Resume-token id: unguessable (a token authorizes replaying a
    session's stream) and cheap. 8 random bytes + a process-local ordinal."""
    return f"es-{os.urandom(8).hex()}-{next(_token_counter)}"


class EdgeSession:
    """One downstream subscriber: identity, keys, delivered versions, and
    a delivery surface.

    Two delivery flavors, chosen at attach time:

    - ``sink`` (synchronous callable ``sink(frame)``): the frame is
      client-visible the moment the callable returns — in-process
      consumers and the 1M-subscriber simulation, where a per-session
      pump task would be 1M tasks. Delivered versions update inline.
    - ``mailbox`` (:class:`KeyedMailbox`): frames coalesce per key until a
      transport pump drains them; the pump calls :meth:`mark_delivered`
      AFTER the transport accepted the batch, so the resume map never
      claims a frame the peer did not receive.

    ``versions`` is the Last-Event-ID-style resume source: key → highest
    version delivered. ``track_versions=False`` (the simulation's memory
    knob) skips the map; such a session resumes from zero (every key
    replays), which is correct, just not minimal.

    Slotted: a million of these must stay in the hundreds of megabytes.
    """

    __slots__ = (
        "token",
        "keys",
        "versions",
        "sink",
        "mailbox",
        "evicted",
        "delivered",
        "on_evicted",
        "on_drain",
        "shard",
    )

    def __init__(
        self,
        keys: Tuple[str, ...],
        sink: Optional[Callable[[Frame], None]] = None,
        mailbox: Optional[KeyedMailbox] = None,
        token: Optional[str] = None,
        track_versions: bool = True,
    ):
        if (sink is None) == (mailbox is None):
            raise ValueError("EdgeSession needs exactly one of sink= or mailbox=")
        self.token = token or _mint_token()
        self.keys = tuple(keys)
        self.versions: Optional[Dict[str, int]] = {} if track_versions else None
        self.sink = sink
        self.mailbox = mailbox
        self.evicted = False
        self.delivered = 0
        #: fan-shard index (assigned by EdgeNode at attach/resume): which
        #: of the node's parallel fan workers delivers to this session
        self.shard = 0
        #: transport shutdown hook the owning connection handler installs:
        #: EdgeNode.evict() calls it after parking, so an eviction that did
        #: NOT originate in the transport pump (mailbox overflow, broken
        #: sink) still aborts the connection instead of leaving the peer
        #: on a silent, heartbeat-alive stream that will never update
        self.on_evicted: Optional[Callable[[], None]] = None
        #: drain hook: EdgeNode.drain() calls it with the
        #: reconnect hint frame INSTEAD of the sink/mailbox — transports
        #: write the hint and close the stream CLEANLY (the peer must
        #: receive its resume token, so this is never an abort); sessions
        #: without a hook get the hint through their normal surface
        self.on_drain: Optional[Callable[[Frame], None]] = None

    def deliver(self, frame: Frame) -> bool:
        """Hand one frame to this session. Returns False when the session
        should be EVICTED (its mailbox overflowed — a slow consumer whose
        pending set outgrew the bound). Never blocks: the sink flavor is
        synchronous by contract, the mailbox flavor just coalesces."""
        if self.evicted:
            return True
        if self.sink is not None:
            self.sink(frame)
            self.delivered += 1
            if self.versions is not None:
                self.versions[frame[0]] = frame[1]
            return True
        mailbox = self.mailbox
        mailbox.push(frame)
        return not mailbox.overflowed

    def mark_delivered(self, frames: List[Frame]) -> None:
        """Transport pump callback: the batch reached the peer — advance
        the resume map (mailbox-flavor sessions only; sink delivery
        advances inline)."""
        self.delivered += len(frames)
        if self.versions is not None:
            for frame in frames:
                self.versions[frame[0]] = frame[1]

    def resume_state(self) -> Dict[str, int]:
        """key → delivered version, as parked on eviction (empty when
        version tracking is off: resume replays every key)."""
        return dict(self.versions) if self.versions is not None else {}
