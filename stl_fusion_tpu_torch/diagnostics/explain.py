"""explain(key) — causal-chain introspection.

Answers the operator's second question: *why is this key stale, who
invalidated it, and did my clients get fenced*. ``explain`` joins four
sources on the cause id the tracing layer threads through the system:

- the **flight recorder** (``flight_recorder.RECORDER``): the key's
  lifecycle events (registered / computed / invalidated / fenced), each
  stamped with cause id + wave seq + oplog index where known;
- the **wave profiler** ring (``TpuGraphBackend.profiler``): the wave
  record the cause names — kind, seeds, newly count, device/apply ms;
- the **tracing span buffer**: span-shaped causes resolve back to the
  originating command/replay span (an ``oplog:replay`` span carries the
  oplog entry index — the "via oplog entry E on host H" link);
- the **fence events**: how many client subscriptions the invalidation
  pushed through ``$sys-c``.

Cross-peer: a client's key is served by its server — the ``$sys-d``
diagnostics service ships an explain request ``[service, method, args]``
to the peer and returns the server-assembled chain
(:func:`explain_remote` / :func:`explain_client`); install both ends with
:func:`install_explain`. Fused, deferred execution is exactly where
per-op behavior disappears (the FuseFlow / nonblocking-GraphBLAS papers
in PAPERS.md motivate introspection for fused dataflow) — this module is
the "why" half of the observability stack.

Everything returned is a JSON-safe dict: it travels verbatim through
``GET /explain?key=`` on the HTTP gateway and the ``$sys-d`` wire codec.

Imports from ``core``/``rpc`` are function-local: ``diagnostics`` is
imported by ``core.computed`` at module scope, so this module must not
close the cycle.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, List, Optional

from .flight_recorder import RECORDER, FlightRecorder, call_key, method_key_fragment
from .tracing import find_span_by_cause

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "explain",
    "explain_with_fallback",
    "explain_remote",
    "explain_client",
    "install_explain",
]


def _resolve(key: Any, hub) -> tuple:
    """``(key_str, computed_or_None)`` for a Computed, a ComputedInput, or
    a key string (matched against the hub registry's input reprs).

    The string path is bounded at :data:`MAX_REGISTRY_SCAN` nodes: a repr
    per registry entry is an O(graph) Python pass, and a live 10M-node hub
    must not stall its event loop on one ``GET /explain`` — past the cap
    the journal (bounded ring) is the only string resolver, which still
    answers the chain for any recently-active key."""
    from ..core.computed import Computed
    from ..core.inputs import ComputedInput

    if isinstance(key, Computed):
        return repr(key.input), key
    if isinstance(key, ComputedInput):
        return repr(key), key.get_existing_computed()
    key_str = str(key)
    if hub is not None and len(hub.registry) <= MAX_REGISTRY_SCAN:
        registry = hub.registry
        with registry._lock:
            items = list(registry._map.items())
        for input, ref in items:
            if repr(input) == key_str:
                return key_str, ref()
    return key_str, None


MAX_REGISTRY_SCAN = 100_000  # string-key resolution cap; see _resolve


def _rec_covers_seq(rec: dict, wave: int) -> bool:
    """Does this profiler record describe wave ``wave``? Exact seq match,
    or — for a physically-fused chain — any seq inside the record's
    ``seq_span`` (one seq per logical wave)."""
    if rec["seq"] == wave:
        return True
    span = rec.get("seq_span")
    return span is not None and span[0] <= wave <= span[1]


def explain(
    key: Any,
    hub=None,
    backend=None,
    recorder: Optional[FlightRecorder] = None,
    max_events: int = 64,
) -> dict:
    """Assemble the causal chain for ``key``.

    Returns a JSON-safe dict: ``key``, ``state`` (live consistency state
    when the node resolves), ``events`` (the flight-journal tail for the
    key), ``invalidation`` (cause id, the wave record, the originating
    span, the oplog entry, clients fenced) and ``chain`` — the
    human-readable lines ("X invalidated by wave W, caused by command C
    via oplog entry E on host H, fenced N clients")."""
    recorder = recorder if recorder is not None else RECORDER
    key_str, computed = _resolve(key, hub)
    if backend is None and hub is not None:
        backend = hub.graph_backend

    keys = [key_str]
    call = getattr(computed, "call", None)  # ClientComputed: fence events
    if call is not None:  # are journaled under the call-shaped key
        keys.append(call_key(call.service, call.method, call.args))
    events: List[dict] = []
    for k in keys:
        events.extend(recorder.for_key(k, limit=max_events))
    events.sort(key=lambda e: e["seq"])
    events = events[-max_events:]

    out: dict = {
        "key": key_str,
        "state": None,
        "events": events,
        "invalidation": None,
        "chain": [],
    }
    if computed is not None:
        out["state"] = computed.consistency_state.name
        out["version"] = computed.version.format()

    # lazy-pending takes PRECEDENCE over the journal: a device wave marked
    # the node's pending bit but the host has not materialized it (that
    # happens on next read) — the wave's identity is not recorded per-node,
    # only the bit (graph/backend.py two-tier apply). Journal events for
    # this key belong to a PRIOR generation of it; attributing the current
    # invalidation to them would name the wrong wave.
    from ..core.consistency import ConsistencyState

    if (
        computed is not None
        and computed._state == ConsistencyState.CONSISTENT
        and computed._pending_probe()
    ):
        out["invalidation"] = {"cause": None, "pending": True}
        out["chain"] = [
            f"{key_str}: invalidated by a device wave (lazy tier — the "
            f"cause materializes when the node is next read or observed)"
        ]
        return out

    # the most recent invalidation's identifiers: the live stamp first
    # (survives ring eviction), the journal tail as the fallback.
    # ClientComputed carries its cause on the bound call (the
    # invalidation_cause property); plain Computeds on the slot.
    cause = wave = oplog = None
    inv_event = None
    if computed is not None and computed.is_invalidated:
        cause = (
            getattr(computed, "invalidation_cause", None)
            or computed._invalidation_cause
        )
    for e in reversed(events):
        if e["kind"] in ("invalidated", "fenced", "client_fenced"):
            if (
                cause is not None
                and e.get("cause") is not None
                and e.get("cause") != cause
            ):
                # a PRIOR generation's event (this key's current
                # invalidation has a different live cause stamp — its own
                # event was evicted or recorded while disabled): harvesting
                # wave/oplog from it would pin the wrong wave record
                continue
            inv_event = e
            cause = cause if cause is not None else e.get("cause")
            wave = e.get("wave")
            oplog = e.get("oplog")
            break
    if cause is None and inv_event is None:
        if computed is not None and computed.is_invalidated:
            # invalidated, but neither a live stamp nor a journal event
            # survived (ring eviction, or the recorder was disabled)
            out["invalidation"] = {"cause": None}
            out["chain"] = [
                f"{key_str}: invalidated, cause unknown (journal evicted "
                f"or recorder disabled)"
            ]
        else:
            state = out["state"] or "unknown"
            out["chain"] = [f"{key_str}: no recorded invalidation (state: {state})"]
        return out

    # reshard cause family: the key was fenced because its shard
    # moved to a new owner — no wave, no span, no oplog entry; the story is
    # the epoch change. The rebalancer journals a per-key "resharded" event
    # whose detail names the owner move, so the chain can say exactly
    # where the key's subscription went.
    if cause is not None and cause.startswith("reshard:"):
        epoch_s = cause.partition(":")[2]
        # match the journal event to THIS invalidation's epoch: after
        # consecutive reshards the key's newest "resharded" event can
        # describe a later epoch's owner move, not the one that fenced it
        moved_ev = next(
            (
                e
                for e in reversed(events)
                if e["kind"] == "resharded" and e.get("cause") == cause
            ),
            None,
        )
        detail = (moved_ev or {}).get("detail") or ""
        line = f"{key_str}: invalidated by reshard to epoch {epoch_s}"
        if "owner " in detail:
            line += f" ({detail[detail.index('owner '):].replace('->', '→')})"
        out["invalidation"] = {
            "cause": cause,
            "reshard_epoch": int(epoch_s) if epoch_s.isdigit() else epoch_s,
            "detail": detail or None,
        }
        out["chain"] = [
            line,
            f"caused by {cause}",
            "the fenced client re-subscribes on the new owner at its next read",
        ]
        return out

    # drain cause family: the frame was not an invalidation at
    # all — an edge node draining for a rolling deploy hinted this session
    # to reconnect, carrying its resume token; nothing upstream changed
    # and resume replay covers any fence that lands during the gap
    if cause is not None and cause.startswith("drain:"):
        edge_name = cause.partition(":")[2]
        out["invalidation"] = {"cause": cause, "drain_edge": edge_name}
        out["chain"] = [
            f"{key_str}: session hinted to reconnect — edge '{edge_name}' "
            f"drained (rolling deploy)",
            f"caused by {cause}",
            "the client resumes elsewhere with the carried token; "
            "latest-wins replay covers anything fenced during the gap "
            "(zero deliveries lost)",
        ]
        return out

    # wave record: an exact seq match wins outright (several waves can
    # share one span-shaped cause — e.g. two cascades under one command
    # span — and a cause-first scan would grab the NEWEST of them, not the
    # one that actually invalidated this key); a logical wave physically
    # FUSED into a chain has no record of its own — any seq inside a
    # record's seq_span resolves to the fused record, with the
    # logical wave still named by its own seq in the chain text; cause
    # matching is only the fallback for events that carried no seq
    wave_rec = None
    profiler = getattr(backend, "profiler", None)
    if profiler is not None:
        recs = profiler.recent()
        if wave is not None:
            wave_rec = next(
                (r for r in reversed(recs) if _rec_covers_seq(r, wave)), None
            )
        if wave_rec is None and wave is None and cause is not None:
            wave_rec = next((r for r in reversed(recs) if r["cause"] == cause), None)

    span_dict = None
    oplog_batch_upto = None
    if cause is not None:
        span = find_span_by_cause(cause)
        if span is not None:
            span_dict = span.to_dict()
            if oplog is None and span.source == "oplog":
                if span.name == "replay":
                    idx = span.tags.get("index")
                    if isinstance(idx, int):
                        oplog = idx
                elif span.name == "batch":
                    # a lane-burst covers SEVERAL oplog records; the span
                    # carries only the batch's watermark bound — report it
                    # as a bound, never as "the" entry (it usually isn't)
                    upto = span.tags.get("upto")
                    if isinstance(upto, int):
                        oplog_batch_upto = upto

    fence_events = recorder.for_cause(cause, kind="client_fenced") if cause else []
    # per-KEY count in the per-key report; the wave-wide total rides
    # beside it explicitly — reporting the wave total as "this key's
    # subscribers" misled exactly the incident reader this exists for
    clients_fenced = sum(
        e.get("count", 1) for e in fence_events if e.get("key") in keys
    )
    wave_clients_fenced = sum(e.get("count", 1) for e in fence_events)
    # the edge hop: an EdgeNode on this process journals one
    # "edge_fenced" per re-fanned key with the count of downstream
    # sessions — the chain then spans server wave → edge → session
    edge_events = recorder.for_cause(cause, kind="edge_fenced") if cause else []
    edge_sessions_fenced = sum(
        e.get("count", 1) for e in edge_events if e.get("key") in keys
    )
    wave_edge_sessions_fenced = sum(e.get("count", 1) for e in edge_events)

    host = cause.split("/", 1)[0] if cause and "/" in cause else None
    out["invalidation"] = {
        "cause": cause,
        "host": host,
        "wave": wave_rec,
        # the LOGICAL wave's seq when the event recorded one (a fused
        # record's own seq is just the chain head — naming it here would
        # misattribute every non-head wave in the chain)
        "wave_seq": (
            wave if wave is not None
            else (wave_rec["seq"] if wave_rec is not None else None)
        ),
        "span": span_dict,
        "oplog": oplog,
        "clients_fenced": clients_fenced,
        "wave_clients_fenced": wave_clients_fenced,
    }
    if edge_events:
        out["invalidation"]["edge_sessions_fenced"] = edge_sessions_fenced
        out["invalidation"]["wave_edge_sessions_fenced"] = wave_edge_sessions_fenced
    if oplog_batch_upto is not None:
        out["invalidation"]["oplog_batch_upto"] = oplog_batch_upto

    from ..core.computed import LAZY_WAVE_DETAIL

    chain: List[str] = []
    inv_detail = (inv_event.get("detail") or "") if inv_event is not None else ""
    if wave_rec is not None:
        span = wave_rec.get("seq_span")
        if (
            span is not None
            and wave is not None
            and wave_rec.get("fused_depth", 1) > 1
        ):
            # the LOGICAL wave keeps its own name even though it was
            # physically fused — the operator greps for "wave#<seq>" and
            # must land on the chain that actually ran it
            chain.append(
                f"{key_str} invalidated by wave #{wave} (physically fused "
                f"into chain #{span[0]}–#{span[1]}, depth "
                f"{wave_rec['fused_depth']}, {wave_rec['kind']}: "
                f"{wave_rec['seeds']} seed(s), {wave_rec['newly']} newly "
                f"invalid across the chain)"
            )
        else:
            chain.append(
                f"{key_str} invalidated by wave #{wave_rec['seq']} "
                f"({wave_rec['kind']}, {wave_rec['seeds']} seed(s), "
                f"{wave_rec['newly']} newly invalid)"
            )
    elif wave is not None:
        chain.append(f"{key_str} invalidated by wave #{wave}")
    elif inv_detail == LAZY_WAVE_DETAIL:
        # a materialized lazy-tier invalidation: the mechanism WAS a device
        # wave even though its identity was never recorded per-node —
        # claiming "host-led" here would misdirect the runbook (exact
        # constant compare, never prose parsing)
        chain.append(
            f"{key_str} invalidated by a device wave "
            f"(materialized lazily — wave identity not recorded per-node)"
        )
    elif cause is not None and "/wave#" in cause:
        # a wave-SHAPED cause with no local wave record: this process is
        # the CLIENT end (no profiler here) — the wave ran on the peer
        # that minted the cause; "host-led" would contradict the cause id
        # printed on the next line
        chain.append(
            f"{key_str} invalidated by a device wave on a remote peer "
            f"(the cause's host — ask it via explain_remote/$sys-d)"
        )
    else:
        chain.append(f"{key_str} invalidated (host-led, no device wave)")
    mesh_info = wave_rec.get("mesh") if wave_rec is not None else None
    if mesh_info is not None:
        # the shard hop, named. The frontier crossed device
        # shards INSIDE the wave (mesh collectives) — the ~80 ms per-key
        # host-relay hop this line used to imply is gone for on-mesh keys.
        line = (
            f"cross-shard frontier exchanged on-mesh via {mesh_info['exchange']} "
            f"collectives ({mesh_info['levels']} level(s) over "
            f"{mesh_info['n_dev']} devices, placement epoch "
            f"{mesh_info['epoch']}) — no host-relay hop"
        )
        # place THIS key's device shard when the backend can
        entry = getattr(backend, "_routed_mirror", None) if backend is not None else None
        nid = backend.id_for(computed) if (backend is not None and computed is not None) else None
        if entry is not None and nid is not None:
            pl = entry["graph"].placement
            shard = pl.shard_of_node(nid)
            if pl.on_mesh(shard):
                dev = int(pl.shard_dev[shard])
                line += (
                    f"; key's device shard #{shard} lives on device {dev} "
                    f"(member {pl.member_of_device(dev)})"
                )
        chain.append(line)
        # the straggler, named. When the wave's cause has trace
        # segments, the stitched timeline knows which (host, shard) paced
        # the worst merge epoch — the line that turns "the wave was slow"
        # into a rebalance target.
        if cause is not None:
            from .mesh_telemetry import global_mesh_trace

            stitched = global_mesh_trace().stitch(cause)
            if stitched is not None and stitched.get("paced_by"):
                p = stitched["paced_by"]
                line = (
                    f"paced by host {p['host']} shard {p['shard']} at level "
                    f"{p['level']} ({p['stall_ms']:.1f} ms stall across "
                    f"{len(stitched['hosts'])} host(s)"
                )
                if stitched["partial"]:
                    line += (
                        f"; PARTIAL — no segments from "
                        f"{','.join(stitched['missing_hosts'])}"
                    )
                chain.append(line + ")")
    if cause is not None:
        line = f"caused by {cause}"
        if host is not None:
            line += f" on host {host}"
        chain.append(line)
        # the cluster commander labels command causes (and the
        # oplog reader re-labels them on replay hosts), so the chain names
        # the WRITE end to end: command → wave seq → delivery
        from .mesh_telemetry import global_mesh_trace

        command_label = global_mesh_trace().command_for(cause)
        if command_label is not None:
            chain.append(f"invalidated by command {command_label}")
    if span_dict is not None:
        chain.append(
            f"originating span: {span_dict['source']}:{span_dict['name']}"
            f"#{span_dict['span_id']}"
        )
    if oplog is not None:
        chain.append(f"via oplog entry {oplog}")
    elif oplog_batch_upto is not None:
        chain.append(f"via an oplog replay batch (entries up to {oplog_batch_upto})")
    if clients_fenced:
        line = f"fenced {clients_fenced} client subscription(s) on this key"
        if wave_clients_fenced > clients_fenced:
            line += f" ({wave_clients_fenced} across the wave)"
        chain.append(line)
    elif wave_clients_fenced:
        chain.append(
            f"the wave fenced {wave_clients_fenced} client subscription(s) "
            f"(none recorded on this key)"
        )
    if edge_sessions_fenced:
        line = (
            f"edge re-fanned to {edge_sessions_fenced} downstream session(s) "
            f"on this key"
        )
        if wave_edge_sessions_fenced > edge_sessions_fenced:
            line += f" ({wave_edge_sessions_fenced} across the wave)"
        # the value-plane rung that produced the fanned value:
        # the edge stamps "value served from wave block / batched re-read /
        # per-key re-read" into its journal detail — surface it so an
        # operator can see WHICH upstream path a fence actually took
        for e in edge_events:
            detail = e.get("detail") or ""
            if e.get("key") in keys and "value served from" in detail:
                line += f" ({detail[detail.index('value served from'):]})"
                break
        chain.append(line)
    elif wave_edge_sessions_fenced:
        chain.append(
            f"the edge re-fanned {wave_edge_sessions_fenced} downstream "
            f"session(s) (none recorded on this key)"
        )
    # the overload plane: sheds journaled against this key —
    # an operator asking "why is this subscriber not seeing updates" gets
    # told the edge turned its attaches away, and why
    shed_events = [e for e in events if e.get("kind") == "edge_shed"]
    if shed_events:
        reasons: dict = {}
        for e in shed_events:
            detail = e.get("detail") or ""
            reason = (
                detail.split("reason=", 1)[1].split()[0]
                if "reason=" in detail
                else "?"
            )
            reasons[reason] = reasons.get(reason, 0) + 1
        chain.append(
            "the edge SHED "
            + ", ".join(f"{n}× {r}" for r, n in sorted(reasons.items()))
            + " attach(es) naming this key (counted in "
            "fusion_edge_shed_total; clients retry per Retry-After)"
        )
    # workload attribution: is this key a tracked heavy hitter?
    # The hot-key board answers with its rank and share per domain — the
    # line that turns "this key is slow" into "this key is 3.1% of all
    # edge deliveries". Checked against the delivery and invalidation
    # sketches; the node-id sketch needs the backend to resolve the key.
    from .hotkeys import global_hotkeys

    board = global_hotkeys()
    hot: list = []
    share = board.share_of("edge_deliveries", key_str)
    if share is not None:
        hot.append(share)
    nid = (
        backend.id_for(computed)
        if (backend is not None and computed is not None)
        else None
    )
    if nid is not None:
        share = board.share_of("wave_invalidations", str(nid))
        if share is not None:
            hot.append(share)
    if hot:
        out["hotkeys"] = hot
        top = max(hot, key=lambda h: h["share"])
        chain.append(
            f"key is a top-k heavy hitter: {top['share'] * 100:.1f}% of "
            f"{top['domain']} (rank {top['rank']}, ~{top['count']} offers, "
            f"over-count ≤ {top['error']})"
        )
    out["chain"] = chain
    return out


def explain_with_fallback(
    key: Any, hub=None, recorder: Optional[FlightRecorder] = None
) -> dict:
    """:func:`explain`, falling back to the journal's FRAGMENT matcher when
    an exact lookup finds nothing — an operator pasting a partial key still
    gets the chain. THE shared resolution used by both operator entry
    points (``GET /explain?key=`` and the ``$sys-d`` string path), so the
    two never drift."""
    rec = recorder if recorder is not None else RECORDER
    report = explain(key, hub=hub, recorder=rec)
    if report.get("state") is None and not report.get("events"):
        matches = rec.keys_matching(str(key), limit=1)
        if matches:
            report = explain(matches[0], hub=hub, recorder=rec)
    return report


# ---------------------------------------------------------------- $sys-d hop


def install_explain(rpc_hub, fusion_hub=None, recorder: Optional[FlightRecorder] = None):
    """Install the ``$sys-d`` diagnostics endpoint on an RPC hub — both the
    server side (answers ``explain`` requests against ``fusion_hub``'s
    registry and this process's flight recorder) and the client side
    (resolves ``explain_result`` replies for :func:`explain_remote`).
    Idempotent; returns the hub.

    Exposure note: the endpoint answers ANY connected peer, so it serves
    only ``[service, method, args]`` requests — shapes the peer could
    invoke as calls anyway; free-form journal scans stay behind the HTTP
    route's proxy-trust gate (see ``_serve_explain``)."""
    pending = getattr(rpc_hub, "_explain_pending", None)
    if pending is None:
        pending = rpc_hub._explain_pending = {}

    async def handler(peer, message) -> None:
        from ..rpc.message import DIAG_SYSTEM_SERVICE, RpcMessage
        from ..utils.serialization import dumps, loads

        if message.method == "explain":
            # every failure class up to the send itself must still produce
            # an error REPLY (the documented contract): a malformed request
            # or a non-serializable report dying in this detached task
            # would otherwise park the asker for its full timeout
            try:
                (req,) = loads(message.argument_data)
                report = await _serve_explain(rpc_hub, fusion_hub, recorder, req)
            except Exception as e:  # noqa: BLE001
                report = {"error": f"{type(e).__name__}: {e}"}
            try:
                payload = dumps([report])
            except Exception as e:  # noqa: BLE001 — a repr slipped something
                payload = dumps([{"error": f"report not serializable: {e}"}])
            await peer.send(
                RpcMessage(
                    0,
                    message.call_id,
                    DIAG_SYSTEM_SERVICE,
                    "explain_result",
                    payload,
                )
            )
        elif message.method == "explain_result":
            # keyed by (peer, call_id): call ids are PER-PEER counters, so
            # two peers of one hub can both allocate id 7 concurrently
            fut = pending.pop((id(peer), message.call_id), None)
            if fut is not None and not fut.done():
                fut.set_result(loads(message.argument_data)[0])

    rpc_hub.diag_system_handler = handler
    return rpc_hub


async def _serve_explain(rpc_hub, fusion_hub, recorder, req) -> dict:
    """Server-side resolution — ``[service, method, args]`` triples ONLY:
    the triple peeks the live computed through the service registry (never
    computing — ``get_existing``), so a peer learns exactly about call
    shapes it could invoke anyway. Bare-string requests are REFUSED: a
    free-form fragment scan over the process-wide journal would disclose
    other tenants' key reprs (embedded call args included) to any
    connected peer — the HTTP route gates that behind proxy trust, and the
    RPC hop must not be the ungated back door. Failures travel as
    ``{"error": ...}`` payloads, never as a torn link."""
    try:
        if isinstance(req, (list, tuple)) and len(req) == 3:
            from ..utils.serialization import deep_tuple

            service, method, args = req
            # args must re-tuple DEEPLY before replay or the interned
            # cache key is unhashable
            args = deep_tuple(args)
            computed = None
            explainable = False
            try:
                from ..core.context import get_existing

                service_def = rpc_hub.service_registry.require(service)
                m = service_def.method(method)
                # ONLY compute methods may be peeked: the GET_EXISTING
                # flag is honored by the @compute_method wrapper alone —
                # a plain RPC method (a mutation!) would EXECUTE outright
                # as a side effect of an introspection request
                if getattr(m.fn, "__compute_method_def__", None) is not None:
                    explainable = True
                    computed = await get_existing(lambda: m.fn(*args))
            except Exception:  # noqa: BLE001 — treated as not-explainable below
                log.debug("explain: registry peek failed for %s.%s", service, method)
            if computed is not None:
                return explain(computed, hub=computed._hub(), recorder=recorder)
            if not explainable:
                # an unresolvable triple must NOT degrade into a journal
                # scan: the fragment match ignores the service name, so a
                # peer probing a made-up service would read lifecycle
                # metadata of keys it cannot invoke (the auditor's private
                # canary included)
                return {
                    "error": f"{service}.{method} is not an explainable "
                    f"compute method on this hub"
                }
            # node collected (or never computed here): the journal may still
            # remember it — match by the method+args fragment of the key
            frag = method_key_fragment(method, args)
            return explain_with_fallback(frag, hub=fusion_hub, recorder=recorder)
        return {
            "error": "explain over $sys-d requires [service, method, args]; "
            "free-form key strings are served only by the trust-gated "
            "HTTP /explain route"
        }
    except Exception as e:  # noqa: BLE001 — introspection must never throw on the pump
        log.exception("explain request failed")
        return {"error": f"{type(e).__name__}: {e}"}


async def explain_remote(peer, service: str, method: str, args, timeout: float = 5.0) -> dict:
    """Ask a PEER who killed a key: ships ``[service, method, args]`` over
    ``$sys-d.explain`` and awaits the server-assembled chain. Requires
    :func:`install_explain` on the asking hub (and on the serving hub)."""
    from ..rpc.message import DIAG_SYSTEM_SERVICE, RpcMessage
    from ..utils.serialization import dumps

    pending = getattr(peer.hub, "_explain_pending", None)
    if pending is None or peer.hub.diag_system_handler is None:
        raise RuntimeError("install_explain(rpc_hub) must run before explain_remote")
    call_id = peer.allocate_call_id()
    fut: asyncio.Future = asyncio.get_event_loop().create_future()
    pending[(id(peer), call_id)] = fut
    try:
        await peer.when_connected()
        await peer.send(
            RpcMessage(
                0,
                call_id,
                DIAG_SYSTEM_SERVICE,
                "explain",
                dumps([[service, method, list(args)]]),
            )
        )
        return await asyncio.wait_for(fut, timeout)
    finally:
        pending.pop((id(peer), call_id), None)


async def explain_client(node, timeout: float = 5.0) -> dict:
    """Both ends of a ClientComputed's story: the LOCAL fence record (this
    process's journal) and the SERVER's causal chain over the ``$sys-d``
    hop — "my key was fenced by call #C" joined to "wave W caused it"."""
    call = node.call
    if call is None:
        raise ValueError(f"{node!r} has no live call (cache-only node)")
    input = node.input
    local = explain(node, hub=node._hub())
    remote = await explain_remote(
        call.peer, input.function_ref.service, input.method, input.args, timeout
    )
    return {"local": local, "remote": remote}
