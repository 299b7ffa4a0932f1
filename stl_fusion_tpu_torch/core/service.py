"""@compute_method + ComputeService — transparent memoization of async methods.

The TPU-native replacement for the reference's compile-time proxy machinery:
where Stl.Fusion generates ``{Name}Proxy`` classes via a Roslyn source
generator and intercepts virtual ``[ComputeMethod]`` calls
(Stl.Generators/ProxyGenerator.cs, Interception/ComputeServiceInterceptor.cs),
Python decorators wrap the method directly — same call path, zero codegen:

    class CartService(ComputeService):
        @compute_method
        async def get_total(self, cart_id: str) -> float: ...

Every call builds a ``ComputeMethodInput`` key, captures the ambient
currently-computing node as the dependency edge source, and runs the
Read→Lock→RetryRead→Compute→Store pipeline (see function.py).
"""
from __future__ import annotations

import functools
import inspect
import weakref
from typing import Any, Callable, Optional

from .context import OPT_INVALIDATE_BIT, CallOptions, ComputeContext, get_current
from .function import ComputeMethodFunction
from .hub import FusionHub, default_hub
from .inputs import ComputeMethodInput, KwArgsTail
from .options import ComputedOptions

__all__ = [
    "compute_method",
    "ComputeService",
    "ComputeMethodDef",
    "InternKeyCodec",
    "TableBacking",
    "hub_of",
    "memo_table_of",
]


class InternKeyCodec:
    """Arbitrary hashable call args ⇄ dense MemoTable row ids.

    The bridge that lets realistic key shapes — string user ids, composite
    (tenant, id) tuples — ride the columnar path (≈ the
    reference's DbEntityResolver batching arbitrary entity keys into dense
    batch slots, EntityFramework/DbEntityResolver.cs): keys are interned on
    first read, ``peek`` never allocates (invalidating a never-read key is
    a no-op, not a row burn), ``decode`` is the reverse map used by
    table→scalar invalidation and by the batch-refresh wrapper. Scoped like
    the MemoTable itself — per (service instance, hub) — so independent
    service instances with disjoint key universes each get the full row
    capacity (``TableBacking(keys=True)`` creates one codec per table; pass
    a codec INSTANCE to share a key→row layout deliberately)."""

    __slots__ = ("capacity", "_row_by_key", "_key_by_row")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._row_by_key: dict = {}
        self._key_by_row: list = []

    def peek(self, args: tuple) -> Optional[int]:
        return self._row_by_key.get(args)

    def acquire(self, args: tuple) -> int:
        row = self._row_by_key.get(args)
        if row is None:
            if len(self._key_by_row) >= self.capacity:
                raise KeyError(
                    f"key codec full ({self.capacity} rows interned); "
                    f"raise TableBacking(rows=...)"
                )
            row = len(self._key_by_row)
            self._row_by_key[args] = row
            self._key_by_row.append(args)
        return row

    def decode(self, row: int) -> Optional[tuple]:
        return self._key_by_row[row] if 0 <= row < len(self._key_by_row) else None

    def __len__(self) -> int:
        return len(self._key_by_row)


class TableBacking:
    """Declarative MemoTable backing for a dense-integer-key compute method.

    The columnar twin of the scalar memoization slot, so an ordinary
    ``@compute_method`` service can transparently ride MemoTable: declaring

        @compute_method(table=TableBacking(rows=1000, batch="get_many",
                                           row_shape=(2,)))
        async def get(self, uid: int): ...

    keeps the scalar call path EXACTLY as before (one Computed node per key,
    the reference's read pipeline) and additionally maintains one
    :class:`~..ops.memo_table.MemoTable` per (service, hub) whose rows are
    refreshed through the service's own ``batch`` method
    (``(ids: np.ndarray) -> rows``). The two stay coherent both ways:

    - invalidating the scalar method (``with invalidating(): await
      svc.get(k)`` — e.g. from a command's invalidation replay) also marks
      table row ``k`` stale;
    - ``table.invalidate(ids)`` also invalidates any LIVE scalar nodes for
      those keys (absent nodes cost nothing).

    Bulk reads ride ``memo_table_of(svc.get).read_batch(ids)`` — one device
    gather per batch, the public columnar path the read benchmark measures.

    Non-integer keys: ``keys=True`` (or an explicit codec object) interns
    arbitrary hashable call args into dense rows via
    :class:`InternKeyCodec`; bulk reads then go through
    ``memo_table_of(svc.get).read_keys(["alice", ...])`` and the ``batch``
    method receives the decoded KEYS (single-arg methods get bare keys,
    multi-arg methods get args tuples), not row ids.
    """

    __slots__ = (
        "rows", "batch", "row_shape", "dtype", "keys", "device_batch",
        "device_args", "device",
    )

    def __init__(
        self, rows: int, batch: str, row_shape: tuple = (), dtype=None, keys=False,
        device_batch: Optional[str] = None, device_args: Optional[str] = None,
        device=None,
    ):
        self.rows = int(rows)
        self.batch = batch
        self.row_shape = tuple(row_shape)
        self.dtype = dtype
        #: False = dense int keys; True = one InternKeyCodec PER TABLE
        #: (per service instance × hub); a codec instance = shared layout
        self.keys = keys
        #: name of a torch method ``(ids: int tensor on the table's device,
        #: *args) -> rows`` — the DEVICE loader: stale-row refreshes then
        #: run entirely on the device from the resident invalid state, zero
        #: host value traffic (TpuGraphBackend.refresh_block_on_device).
        #: Dense int keys only. ``device_args`` names a method returning the
        #: loader's tensors.
        self.device_batch = device_batch
        self.device_args = device_args
        #: the table's device when the hub has no graph backend (with one,
        #: the table lives on the backend's device); None means ``cuda``
        self.device = device
        if device_batch is not None and keys:
            raise ValueError("device_batch requires dense int keys (keys=False)")

    def make_codec(self) -> Optional["InternKeyCodec"]:
        if self.keys is True:
            return InternKeyCodec(self.rows)
        return self.keys or None

    def covers(self, args: tuple) -> bool:
        """Could these call args EVER map to a table row? (A cheap shape
        check at node-creation time; the row itself resolves lazily at
        invalidation time through ``row_for_args``, which is the authority
        — including for normalized keys carrying a defaults tail.)"""
        if self.keys:
            return True
        return len(args) >= 1 and isinstance(args[0], int)


class ComputeMethodDef:
    """Per-method metadata + per-(hub) function cache
    (≈ ComputeMethodDef, Interception/ComputeMethodDef.cs)."""

    __slots__ = (
        "original", "name", "options", "signature", "table", "_functions",
        "_pos_defaults", "_n_required", "_hashable_defaults",
    )

    def __init__(self, original: Callable, options: ComputedOptions,
                 table: Optional[TableBacking] = None):
        self.original = original
        self.name = original.__qualname__
        self.options = options
        self.signature = inspect.signature(original)
        self.table = table
        self._functions: dict = {}
        # defaults tail for kwargs-free normalization (bind_args): only for
        # plain positional-or-keyword signatures. *args/**kwargs/keyword-
        # only methods normalize through signature.bind into a positional
        # prefix + KwArgsTail key (replayable — a flat positional tuple
        # would TypeError at invoke_original).
        params = list(self.signature.parameters.values())[1:]  # drop self
        simple = all(
            p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD for p in params
        )
        self._pos_defaults = tuple(p.default for p in params) if simple else None
        # syntax guarantees defaults are a contiguous tail, so "the tail
        # from len(args) has no empty default" ⇔ len(args) ≥ required count
        self._n_required = sum(
            1 for p in params if p.default is inspect.Parameter.empty
        )
        # an UNHASHABLE default (b=[]) can never ride a cache key: keep the
        # old raw-args identity for such methods instead of crashing every
        # defaulted call at input-hash time
        try:
            hash(tuple(
                p.default for p in params
                if p.default is not inspect.Parameter.empty
            ))
            self._hashable_defaults = True
        except TypeError:
            self._hashable_defaults = False

    def get_function(self, service: Any) -> ComputeMethodFunction:
        hub = hub_of(service)
        fn = self._functions.get(id(hub))
        if fn is None:
            fn = ComputeMethodFunction(hub, self)
            self._functions[id(hub)] = fn
        return fn

    def get_table(self, service: Any):
        """The (service, hub)-scoped MemoTable, created on first use and
        wired for two-way invalidation coherence. Lazy so services that
        declare a backing but never take the columnar path pay nothing.
        Stored ON the service instance (not this class-lifetime def), so a
        dropped service releases its table — including the HBM values."""
        if self.table is None:
            raise TypeError(f"{self.name} has no table= backing declared")
        hub = hub_of(service)
        store = service.__dict__.setdefault("_fusion_memo_tables", {})
        key = (id(hub), self.name)
        table = store.get(key)
        if table is None:
            from ..ops.memo_table import MemoTable

            spec = self.table
            batch_fn = getattr(service, spec.batch)
            codec = spec.make_codec()  # PER-TABLE: instances don't share rows
            arity = len(self.signature.parameters) - 1  # minus self
            if codec is not None:
                # codec-backed tables refresh through KEYS: the service's
                # batch method sees what it declared (string ids, tuples),
                # never internal row numbers. Single-arg methods get bare
                # keys by DECLARED arity — a tuple-valued key of a 1-arg
                # method stays one key
                raw_batch = batch_fn

                def batch_fn(ids):
                    keys = []
                    for i in ids:
                        args = codec.decode(int(i))
                        if args is None:
                            raise KeyError(
                                f"row {int(i)} has no interned key — read "
                                f"codec-backed tables via read_keys()"
                            )
                        keys.append(args[0] if arity == 1 else args)
                    return raw_batch(keys)

            # the table lives where the hub's graph backend mirrors the graph
            # (a row block's refresh runs there), else on TableBacking.device
            backend = hub.graph_backend
            device = backend.graph.device if backend is not None else spec.device
            table = MemoTable(
                spec.rows, batch_fn, row_shape=spec.row_shape, dtype=spec.dtype, device=device
            )
            table.key_codec = codec
            table.key_arity = arity
            if spec.device_batch is not None:
                table.device_compute_fn = getattr(service, spec.device_batch)
                if spec.device_args is not None:
                    table.device_loader_args = getattr(service, spec.device_args)
            # table → scalar: a row invalidation reaches any LIVE scalar
            # node for that key (one registry probe per id; nodes that were
            # never read don't exist and cost nothing). node.invalidate()
            # is idempotent, which is what breaks the scalar↔table cycle.
            function = self.get_function(service)
            registry = hub.registry
            method_def = self

            def on_invalidate(ids) -> None:
                for i in ids:
                    args = method_def.args_for_row(int(i), table)
                    if args is None:
                        continue  # never-interned row: no scalar node exists
                    node = registry.get(
                        ComputeMethodInput(method_def, service, args, function)
                    )
                    if node is not None:
                        node.invalidate()

            table.on_invalidate.append(on_invalidate)
            store[key] = table
        return table

    def row_for_args(self, args: tuple, table) -> Optional[int]:
        """The row these call args map to in ``table``, WITHOUT allocating
        (invalidation paths: a key the columnar side never read has no row
        to mark). None when unmapped. The codec lives on the TABLE — it is
        per (service instance, hub), like the rows it allocates."""
        if self.table is None or table is None:
            return None
        codec = table.key_codec
        if codec is None:
            if len(args) == 1 and isinstance(args[0], int):
                return args[0]
            # normalized key of a defaulted method: (row, *defaults tail)
            # still maps to its row — dropping it here would sever scalar→
            # table invalidation coherence for every defaulted table method
            d = self._pos_defaults
            if (
                d is not None
                and len(d) > 1
                and len(args) == len(d)
                and isinstance(args[0], int)
                and args[1:] == d[1:]
            ):
                return args[0]
            return None
        return codec.peek(tuple(args))

    def args_for_row(self, row: int, table) -> Optional[tuple]:
        """Canonical call args for a row of ``table`` (the reverse map used
        by table→scalar invalidation). Must return the NORMALIZED key —
        scalar nodes of a defaulted method register under
        ``(row, *defaults)``, so the short ``(row,)`` would miss them in
        the registry."""
        if self.table is None or table is None:
            return None
        codec = table.key_codec
        if codec is None:
            d = self._pos_defaults
            if (
                d is not None
                and len(d) > 1
                and self._n_required <= 1  # everything past the row defaults
                and self._hashable_defaults
            ):
                return (int(row),) + d[1:]
            return (int(row),)
        return codec.decode(int(row))

    def peek_table(self, service: Any):
        """The backing table if it was EVER materialized for this service
        (invalidations must not force-create a table nobody reads)."""
        if self.table is None:
            return None
        store = service.__dict__.get("_fusion_memo_tables")
        if store is None:
            return None
        return store.get((id(hub_of(service)), self.name))

    def bind_args(self, service: Any, args: tuple, kwargs: dict) -> tuple:
        """Normalize (args, kwargs) → one canonical cache key per logical
        call, so ``get(x=1)``, ``get(1)`` and ``get(1, b=default)`` share
        one slot (each shape keying its own node would let invalidation of
        one leave the others stale). Plain positional-or-
        keyword signatures key a pure positional tuple (kwargs-free calls
        append the precomputed defaults tail — no ``signature.bind`` on the
        hot path); signatures with keyword-only or ``*``/``**`` params key
        ``(*positional, KwArgsTail)``, which invoke_original can replay.
        Calls omitting a REQUIRED argument pass through raw and fail at
        invocation, like any call."""
        d = self._pos_defaults
        if not kwargs and d is not None:
            if (
                len(args) >= len(d)
                or len(args) < self._n_required
                or not self._hashable_defaults
            ):
                return args
            return args + d[len(args):]
        try:
            bound = self.signature.bind(service, *args, **kwargs)
        except TypeError:
            # mis-shaped call: keep raw identity; invocation raises the
            # same TypeError the direct call would
            if kwargs:
                return args + (KwArgsTail(sorted(kwargs.items())),)
            return args
        if self._hashable_defaults:
            bound.apply_defaults()  # unhashable defaults must never key
        if d is not None:
            return tuple(bound.arguments.values())[1:]  # drop self
        pos = bound.args[1:]  # drop self
        kw = bound.kwargs
        return pos + ((KwArgsTail(sorted(kw.items())),) if kw else ())


def _make_hot_evictor(hot: dict, key):
    """Weakref finalizer dropping a hot-cache entry when its node is
    collected — without it, high-cardinality keyspaces would leak one
    (args-tuple → dead weakref) entry per key forever. Guarded by identity:
    a displaced-and-repopulated key must not lose its LIVE entry."""

    def evict(ref):
        if hot.get(key) is ref:
            del hot[key]

    return evict


def hub_of(service: Any) -> FusionHub:
    hub = getattr(service, "_fusion_hub", None)
    return hub if hub is not None else default_hub()


def memo_table_of(bound_method):
    """The MemoTable behind a table-backed compute method:
    ``memo_table_of(svc.get).read_batch(ids)`` is the public columnar read
    (one device gather per batch). Raises if the method has no ``table=``
    backing declared."""
    method_def = getattr(bound_method, "__compute_method_def__", None)
    service = getattr(bound_method, "__self__", None)
    if method_def is None or service is None:
        raise TypeError(f"{bound_method!r} is not a bound @compute_method")
    return method_def.get_table(service)


def compute_method(
    fn: Optional[Callable] = None,
    *,
    min_cache_duration: Optional[float] = None,
    auto_invalidation_delay: Optional[float] = None,
    invalidation_delay: Optional[float] = None,
    transient_error_invalidation_delay: Optional[float] = None,
    table: Optional[TableBacking] = None,
):
    """Decorator turning an async method into a memoized compute method.

    ≈ ``[ComputeMethod]`` (ComputeMethodAttribute.cs + ComputedOptions.cs
    resolution). Options map 1:1 onto ComputedOptions.
    """

    def decorate(func: Callable) -> Callable:
        if not inspect.iscoroutinefunction(func):
            raise TypeError(f"@compute_method requires an async def, got {func!r}")
        options = ComputedOptions.new(
            min_cache_duration=min_cache_duration,
            auto_invalidation_delay=auto_invalidation_delay,
            invalidation_delay=invalidation_delay,
            transient_error_invalidation_delay=transient_error_invalidation_delay,
        )
        method_def = ComputeMethodDef(func, options, table)
        # per-service HOT cache attribute: args → weakref(consistent node).
        # Weak entries keep the registry's lifecycle authoritative (pruner /
        # keep-alive expiry still collect nodes; a dead or inconsistent
        # entry just falls through to the full path and is re-populated).
        hot_attr = f"_fusion_hot_{func.__qualname__.replace('.', '_')}"

        @functools.wraps(func)
        async def wrapper(self, *args, **kwargs):
            context = ComputeContext.current()
            copts = context.call_options
            if copts == 0 and not kwargs:
                # memoized-hit FAST path (the reference's 50M-ops/sec READ,
                # Function.cs:56): default call mode + consistent node →
                # attach the edge and return with no input construction, no
                # registry probe, no awaits (≈1 dict hit + 1 weakref deref)
                hot = self.__dict__.get(hot_attr)
                if hot is not None:
                    ref = hot.get(args)
                    if ref is not None:
                        existing = ref()
                        if existing is not None and existing.is_consistent:
                            used_by = get_current()
                            if used_by is not None:
                                used_by.add_used(existing)
                            if existing._ka_skip == 0:
                                # every 16th hit (the renewal cadence):
                                # amortized access accounting for monitors
                                existing.input.function.hub.registry.fast_hits += 16
                            existing.renew_timeouts(False)
                            return existing._output.value
                        if existing is None:
                            hot.pop(args, None)  # collected (evictor may race)
            function = method_def.get_function(self)
            input = ComputeMethodInput(
                method_def, self, method_def.bind_args(self, args, kwargs), function
            )
            if copts == 0:
                registry = function.hub.registry
                # peek, not get: on a miss, invoke's own READ is the ONE
                # counted access — a get here would make every miss count
                # twice and read as a phantom hit in monitors
                existing = registry.peek(input)
                if existing is None or not existing.is_consistent:
                    value = await function.invoke_and_strip(input, get_current(), context)
                    existing = registry.peek(input)
                    if existing is None or not existing.is_consistent:
                        return value
                else:
                    registry.count_access(input)  # a served warm hit
                    used_by = get_current()
                    if used_by is not None:
                        used_by.add_used(existing)
                    existing.renew_timeouts(False)
                    value = existing.output.value
                hot = self.__dict__.get(hot_attr)
                if hot is None:
                    hot = self.__dict__[hot_attr] = {}
                key = input.args
                ref = weakref.ref(existing, _make_hot_evictor(hot, key))
                hot[key] = ref
                if not kwargs and args != key:
                    # the fast path probes by the RAW positional tuple; a
                    # call omitting defaulted params normalizes to a longer
                    # key — alias the raw tuple to the same node
                    # so such calls fast-path too. SOUND only kwargs-free:
                    # the normalized key is then a pure function of the raw
                    # tuple. Kwargs calls never alias (get(1, b=3) raw-keys
                    # as (1,), which must stay free for the real get(1)) and
                    # are excluded from the fast path by design — they pay
                    # the slow path's registry probe, the documented cost.
                    hot[args] = weakref.ref(existing, _make_hot_evictor(hot, args))
                return value
            # the ambient computing node is the dependency-capture root —
            # except inside an invalidation replay, where no edges form.
            # scalar → table coherence lives on the node itself (see
            # ComputeMethodFunction.create_computed), so EVERY invalidation
            # path marks the columnar row stale — but a replay for a key
            # with NO live node must still reach the row (the columnar
            # cache exists independently of scalar nodes), handled here
            # without double-firing when a node does exist.
            invalidate_mode = bool(copts & OPT_INVALIDATE_BIT)
            node_existed = (
                function.hub.registry.get(input) is not None
                if invalidate_mode and method_def.table is not None
                else True
            )
            used_by = None if invalidate_mode else get_current()
            result = await function.invoke_and_strip(input, used_by, context)
            if invalidate_mode and method_def.table is not None and not node_existed:
                tbl = method_def.peek_table(self)
                if tbl is not None:
                    row = method_def.row_for_args(input.args, tbl)
                    if row is not None:
                        tbl.invalidate([row])
            return result

        wrapper.__compute_method_def__ = method_def  # type: ignore[attr-defined]
        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate


class ComputeService:
    """Optional base for compute services: explicit hub binding + helpers.

    Any class works with @compute_method; inheriting this adds hub plumbing
    (≈ IComputeService marker)."""

    _fusion_hub: Optional[FusionHub] = None

    def __init__(self, hub: Optional[FusionHub] = None):
        self._fusion_hub = hub

    def _bind_hub(self, hub: FusionHub) -> None:
        self._fusion_hub = hub
