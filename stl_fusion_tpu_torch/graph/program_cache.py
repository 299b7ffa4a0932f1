"""Resident programs: the lane chain and the super-round as captured CUDA graphs.

Port of ``stl_fusion_tpu/graph/program_cache.py``. The JAX package keeps its
compiled lane, chain and super-round programs resident (one XLA executable
per geometry) and across restarts in XLA's persistent compilation cache.
PyTorch compiles nothing, so what stays resident on the card is a **CUDA
graph** (``torch.cuda.CUDAGraph``): :class:`ChainProgram` captures the K
stages of a chain or super-round (the gate's torch operations, the
``topo_sweep`` passes, ``lane_finish``, the loader's gather and
``block_refresh``, ``ops/topo_wave.py::_chain_stages``) once per key, and
every later dispatch of the same key is ONE ``replay()``.

The key is JAX's ``(words, passes, update_valid, n_tot, level_starts, base,
n_rows)`` plus the depth K and the seed tensor's shape; one program per key.
A graph replays fixed addresses, so each program also remembers every
tensor it captured (the graph's invalid words, the mirror's tables, the
table's values and validity, the loader's arguments) and holds a reference
to each, so their memory cannot be reused by anything else while the graph
lives: a dispatch whose tensors are not those same tensors (a dirty graph
re-uploaded its words, a re-level installed new mirror tables, the table
re-materialised its validity) RE-CAPTURES, counted in :data:`STATS`
(``recaptures``), and the old graph and its memory pool go. Before a first
capture the body runs once on a side stream against clones of the tensors
it writes (CUDA's lazy module loading and PyTorch's allocator warm there, as
``torch.cuda.graph`` requires), so capture itself changes no state.

Host side effects of the body run once, at capture, never at replay: the
kernels' launch counters (``topo_sweep``'s ``launches``, ``lane_finish``'s,
``block_refresh``'s) are rolled back after the capture and each replay adds
the launches the capture recorded. Seeds reach the graph's static input by
a non-blocking copy from a pinned host buffer (:class:`PinnedPool`: a
buffer is not rewritten until an event shows its copy done); the outputs
(lane counts and newly masks) are copied non-blocking into pinned buffers
right after the replay, and the harvest waits on one event
(:class:`ChainOutputs`). A capture that fails (say, a loader that reads a
value back to the host) raises ``RuntimeError``, which the callers turn
into JAX's counted eager path, never a silent one. The adaptive sweep
(``passes <= 0``) reads a flag back once per pass, which capture forbids:
those programs run their stages stream-ordered (``STATS["uncaptured"]``).
On a CPU tensor every program runs the plain body.

Kept from the JAX module: :func:`enable_program_cache` (which anchors the
topo-mirror disk cache, ``FUSION_MIRROR_CACHE``, as JAX does; the XLA
compile-cache directory has no counterpart and is reported as None),
:class:`time_program_warm`, :func:`program_warm_report` (the bench's
``cold_start.programs`` record) and :func:`program_cache_stats`.
"""
from __future__ import annotations

import logging
import os
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch

from ..diagnostics.metrics import global_metrics

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "ChainOutputs",
    "ChainProgram",
    "NotFusible",
    "PinnedPool",
    "STATS",
    "enable_program_cache",
    "program_cache_stats",
    "program_warm_report",
    "reset_program_warms",
    "time_program_warm",
]


class NotFusible(RuntimeError):
    """The fused path cannot serve a chain or super-round right now (no
    valid mirror, too many sweep passes, a program that cannot be captured):
    the caller takes its counted eager path. Its own class, because torch
    reports a failed CUDA launch or a device-side error as a
    ``RuntimeError`` too, and that one is a fault."""


#: env override for the cache root (matches FUSION_MIRROR_CACHE's shape)
CACHE_ENV = "FUSION_PROGRAM_CACHE"

#: process-wide program counters: graphs captured (first captures and
#: re-captures), re-captures after a pointer change, replays, capture
#: failures, and stream-ordered (adaptive) runs on the card
STATS = {"captures": 0, "recaptures": 0, "replays": 0, "capture_failures": 0,
         "uncaptured": 0}
#: every program made, to count the captured graphs alive now
_PROGRAMS: "weakref.WeakSet" = weakref.WeakSet()


def _launch_counters():
    """(module, attribute) of every kernel counter a chain body advances."""
    from ..ops import block_refresh, topo_wave

    return ((topo_wave, "launches"), (topo_wave, "lane_finish_launches"),
            (block_refresh, "launches"))


class PinnedPool:
    """Reusable pinned host buffers by (shape, dtype). :meth:`take` hands out
    a buffer no pending copy still reads or writes (each buffer carries the
    CUDA event of its last copy); :meth:`put` returns one with that event."""

    def __init__(self):
        self._free: dict = {}

    def take(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        bufs = self._free.get(key, [])
        for i, (buf, ev) in enumerate(bufs):
            if ev is None or ev.query():
                del bufs[i]
                return buf
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def put(self, buf: torch.Tensor, event=None) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append((buf, event))


#: the pool every chain program and super-round stages through
PINNED = PinnedPool()


class ChainOutputs:
    """A dispatched program's lane counts int32[K, 32W] and newly mask words
    [K, nw]: device tensors on their way into pinned host buffers (CUDA),
    or the tensors themselves (CPU). :meth:`fetch` waits on the copy's event
    and returns numpy arrays; ``device_ms`` is the replay's (or the
    stream-ordered run's) time between CUDA events around it."""

    __slots__ = ("counts", "masks", "event", "events", "route", "device_ms", "_host")

    def __init__(self, counts, masks, route: str, events=None):
        self.route = route  # "plain" | "capture" | "recapture" | "replay" | "stream"
        self.events = events
        self.device_ms: Optional[float] = None
        self._host = None
        self.event = None
        if counts.device.type == "cuda":
            hc = PINNED.take(counts.shape, counts.dtype)
            hm = PINNED.take(masks.shape, masks.dtype)
            hc.copy_(counts, non_blocking=True)
            hm.copy_(masks, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            counts, masks = hc, hm
        self.counts, self.masks = counts, masks

    def fetch(self):
        """(lane_counts, masks) as numpy, blocking on the device once."""
        if self._host is None:
            if self.event is not None:
                self.event.synchronize()
                if self.events is not None:
                    self.device_ms = self.events[0].elapsed_time(self.events[1])
                self._host = (self.counts.numpy().copy(), self.masks.numpy().copy())
                PINNED.put(self.counts)
                PINNED.put(self.masks)
            else:
                self._host = (self.counts.numpy(), self.masks.numpy())
        return self._host


def _ident(t):
    """What a capture bakes in of one argument: a tensor's address, shape
    and dtype, or a plain value itself."""
    if isinstance(t, torch.Tensor):
        return (t.data_ptr(), tuple(t.shape), t.dtype)
    return t if t is None or isinstance(t, (int, float, bool, str)) else ("id", id(t))


class ChainProgram:
    """K stages of a lane chain, or a super-round, as one program.

    ``body(g_invalid, seeds, values, valid, fixed) -> (lane_counts, masks)``
    runs the stages (``ops/topo_wave.py::_chain_stages``) against the
    tensors it is given: ``g_invalid`` (the graph's words), ``seeds``
    (int32[K, 32W, S]), and, for a super-round, the table's ``values`` and
    ``valid`` (None when validity is left alone); it writes those IN PLACE
    and only reads ``fixed``, the mirror's tables and the loader's
    arguments (tensors, or plain values, which a capture bakes in).
    :meth:`dispatch` runs it: on the CPU the body itself, on the card one
    replay of the graph captured for exactly these tensors (capturing or
    re-capturing first), or the body stream-ordered when ``capture`` is
    False (the adaptive sweep)."""

    def __init__(self, key, body: Callable, capture: bool = True):
        self.key = key
        self.body = body
        self.capture = capture
        self.graph = None
        self.idents: Optional[tuple] = None
        self.refs: tuple = ()
        self.seeds: Optional[torch.Tensor] = None  # the graph's static seed input
        self.out: Optional[tuple] = None  # the graph's static outputs
        self.launch_deltas: list = []
        self.replays = 0
        self.captures = 0
        self.cold_ms: Optional[float] = None  # capture + first replay, host clock
        _PROGRAMS.add(self)

    def _capture(self, g_invalid, values, valid, fixed) -> None:
        counters = _launch_counters()
        # warm on clones, on a side stream: what the body writes stays untouched
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(g_invalid.clone(), self.seeds,
                      None if values is None else values.clone(),
                      None if valid is None else valid.clone(), fixed)
        torch.cuda.current_stream().wait_stream(side)
        before = [getattr(mod, name) for mod, name in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self.body(g_invalid, self.seeds, values, valid, fixed)
        except Exception as e:  # noqa: BLE001 — surfaced as the counted eager path
            # recording runs no kernel (the warm run above did, outside
            # this try): what fails here is the capture, never the device
            for (mod, name), v in zip(counters, before):
                setattr(mod, name, v)
            STATS["capture_failures"] += 1
            log.warning("chain program %s: capture failed (%r)", self.key, e)
            raise NotFusible(f"chain program capture failed: {e!r}") from e
        # the capture launched nothing: its counts move to each replay
        self.launch_deltas = []
        for (mod, name), v in zip(counters, before):
            self.launch_deltas.append((mod, name, getattr(mod, name) - v))
            setattr(mod, name, v)
        self.graph, self.out = graph, out
        self.captures += 1
        STATS["captures"] += 1

    def dispatch(self, g_invalid, seeds, values=None, valid=None, fixed=()) -> ChainOutputs:
        """Run the K stages on ``seeds`` (a numpy array, or a pinned CPU
        tensor, int32[K, 32W, S]). Returns the pending outputs."""
        fixed = tuple(fixed)
        device = g_invalid.device
        if device.type == "cpu":
            src = seeds if isinstance(seeds, torch.Tensor) else torch.from_numpy(seeds)
            counts, masks = self.body(g_invalid, src, values, valid, fixed)
            return ChainOutputs(counts, masks, "plain")
        pinned = seeds
        if not isinstance(seeds, torch.Tensor):
            pinned = PINNED.take(seeds.shape, torch.int32)
            pinned.numpy()[...] = seeds
        if self.seeds is None or tuple(self.seeds.shape) != tuple(pinned.shape):
            self.release()
            self.seeds = torch.empty(tuple(pinned.shape), dtype=torch.int32, device=device)
        self.seeds.copy_(pinned, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        PINNED.put(pinned, copied)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        if not self.capture:
            STATS["uncaptured"] += 1
            ev[0].record()
            counts, masks = self.body(g_invalid, self.seeds, values, valid, fixed)
            ev[1].record()
            return ChainOutputs(counts, masks, "stream", ev)
        refs = (g_invalid, values, valid, *fixed)
        idents = tuple(_ident(t) for t in refs)
        route = "replay"
        if self.graph is None or idents != self.idents:
            route = "capture" if self.graph is None else "recapture"
            if self.graph is not None:
                STATS["recaptures"] += 1
                log.info("chain program %s: captured tensors moved, re-capturing", self.key)
            self.graph, self.out = None, None
            t0 = time.perf_counter()
            self._capture(g_invalid, values, valid, fixed)
            self.idents, self.refs = idents, refs
        ev[0].record()
        self.graph.replay()
        ev[1].record()
        if route != "replay":
            torch.cuda.current_stream().synchronize()
            self.cold_ms = (time.perf_counter() - t0) * 1e3
        self.replays += 1
        STATS["replays"] += 1
        for mod, name, d in self.launch_deltas:
            setattr(mod, name, getattr(mod, name) + d)
        return ChainOutputs(self.out[0], self.out[1], route, ev)

    def release(self) -> None:
        """Drop the captured graph, its memory pool and the tensors it held."""
        self.graph, self.out, self.refs, self.idents, self.seeds = None, None, (), None, None


class ProgramCache(OrderedDict):
    """At most ``cap`` programs, least recently used evicted (each captured
    graph holds its own memory pool: at 10M rows and W = 16 a super-round's
    sweep state and seed bits alone are ~1.4 GB)."""

    def __init__(self, cap: int = 4):
        super().__init__()
        self.cap = cap

    def get_or_make(self, key, make: Callable[[], ChainProgram]) -> ChainProgram:
        prog = self.get(key)
        if prog is None:
            prog = make()
            self[key] = prog
            while len(self) > self.cap:
                _, old = self.popitem(last=False)
                old.release()
        else:
            self.move_to_end(key)
        return prog


def _default_root() -> str:
    return os.environ.get(
        CACHE_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "stl_fusion_tpu_torch"),
    )


def enable_program_cache(
    root: Optional[str] = None,
    *,
    jax_dir: Optional[str] = None,
    mirror_dir: Optional[str] = None,
    min_compile_seconds: float = 1.0,
    mirror_cache: bool = True,
) -> dict:
    """Point the topo-mirror disk cache at ``<root>/mirror`` (or
    ``mirror_dir``) unless ``FUSION_MIRROR_CACHE`` is already set, as the
    JAX package does. The rest of the JAX call configures XLA's persistent
    compilation cache, which has no counterpart here: the port compiles its
    kernels once per source (``ops/_build.py``) and keeps its programs
    resident as captured CUDA graphs in process, so ``jax_dir`` and
    ``min_compile_seconds`` are accepted and ignored, and the info dict
    reports ``jax_cache_dir`` as None. Returns ``{root, jax_cache_dir,
    mirror_cache_dir, enabled, error}``; ``enabled`` is True (resident
    programs are always on)."""
    root = root or _default_root()
    mirror_dir = mirror_dir or os.path.join(root, "mirror")
    info = {"root": root, "jax_cache_dir": None, "mirror_cache_dir": None, "enabled": True,
            "error": None}
    if mirror_cache:
        os.environ.setdefault("FUSION_MIRROR_CACHE", mirror_dir)
        info["mirror_cache_dir"] = os.environ["FUSION_MIRROR_CACHE"]
    global_metrics().gauge(
        "fusion_program_cache_enabled",
        help="1 when resident programs (captured CUDA graphs) are active",
    ).set(1)
    return info


#: per-program warm records: name -> {"key", "warm_s", "cache_hit",
#: "new_entries"} (insertion-ordered; the bench cold_start block reports it)
_PROGRAM_WARMS: dict = {}


class time_program_warm:
    """Context manager timing ONE program family's warm-up, as the JAX
    one: ``key`` names what the program is keyed on (geometry, depth), so
    two runs with different keys never read as the same warm. Here the
    record's ``new_entries`` counts the CUDA graphs captured inside the
    block (:data:`STATS`), and ``cache_hit`` is True when the warm captured
    none (every dispatch replayed a resident graph). Records land in
    :func:`program_warm_report`; ``live_path.py`` folds them into the
    record's ``cold_start`` block.

    Usage::

        with time_program_warm("superround", key=(n, groups, depths)):
            prog.dispatch(prog.stage(bursts)); prog.drain()
    """

    def __init__(self, name: str, key=None, jax_dir: Optional[str] = None):
        self.name = name
        self.key = key
        self._t0 = 0.0
        self._captures0 = 0

    def __enter__(self):
        self._captures0 = STATS["captures"]
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        new = STATS["captures"] - self._captures0
        _PROGRAM_WARMS[self.name] = {
            "key": repr(self.key) if self.key is not None else None,
            "warm_s": round(time.perf_counter() - self._t0, 3),
            "new_entries": int(new),
            "cache_hit": new <= 0,
        }
        return False


def program_warm_report() -> dict:
    """Everything :class:`time_program_warm` recorded this process — the
    bench ``cold_start.programs`` block."""
    return {k: dict(v) for k, v in _PROGRAM_WARMS.items()}


def reset_program_warms() -> None:
    _PROGRAM_WARMS.clear()


def program_cache_stats(root: Optional[str] = None) -> dict:
    """The JAX function counts XLA's cached executables on disk; the port's
    resident programs live in process, so ``entries`` is the count of
    captured CUDA graphs alive now, and ``dir``/``bytes`` are None/0. The
    counters of :data:`STATS` ride along."""
    live = sum(1 for p in list(_PROGRAMS) if p.graph is not None)
    return {"dir": None, "entries": live, "bytes": 0, **STATS}
