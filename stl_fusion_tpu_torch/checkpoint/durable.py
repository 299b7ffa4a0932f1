"""Durable snapshot envelope + epoch-consistent cluster state.

The on-disk contract the warm-rejoin path (cluster/rejoin.py) restores
through. Two layers:

- **Envelope v2** — every snapshot file is written atomically (temp +
  flush + fsync + rename + directory fsync) and carries a one-line header
  ``FUSNAP2 <sha256> <watermark> <commit_floor>`` over the payload. A torn
  or bit-flipped file fails the checksum and raises
  :class:`CorruptSnapshotError` instead of deserializing garbage; the
  header alone is enough for the oplog trimmer's snapshot clamp
  (``CheckpointManager.snapshot_floor``) without reading the payload.
  Files written before this format (no magic) still load as legacy v1.
- **DurableHubState** — the epoch-consistent snapshot the issue names:
  the :class:`~stl_fusion_tpu_torch.checkpoint.HubCheckpoint` body (computeds +
  dependency edges + MemoTable columnar state, i.e. the host truth the
  CSR mirror re-derives from) keyed to a ``(shard-map epoch, oplog
  watermark)`` pair, plus the server's live fan-out subscriptions (which
  keys which peers were subscribed to at snapshot time — the sockets die
  with the process, but the restore report and flight recorder name what
  was being served, and the rejoin fence can reason about them).

Consistency note: the pair is captured with the watermark read FIRST and
the hub state after — so the snapshot's warm values reflect *at least*
every oplog entry at/below the watermark. Replaying the tail above the
watermark on restore can re-invalidate an entry that was already fresh
(idempotent, version-matched) but can never miss a committed operation —
the same at-least-once rule the reader's own watermark advance follows.
"""
from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.serialization import dumps, loads

log = logging.getLogger("stl_fusion_tpu_torch")

__all__ = [
    "CorruptSnapshotError",
    "DurableHubState",
    "atomic_write",
    "read_snapshot_file",
    "read_snapshot_header",
    "write_snapshot_file",
]

_MAGIC = b"FUSNAP2"


class CorruptSnapshotError(Exception):
    """A snapshot file that exists but cannot be trusted: truncated mid-
    write, checksum mismatch, or an undecodable payload. Restore paths
    catch this and fall back to the next-newest snapshot instead of
    serving (or crashing on) garbage."""


# ---------------------------------------------------------------- envelope
def _fsync_dir(path: str) -> None:
    """Durability for the RENAME itself — without the directory fsync a
    crash can forget the new name while keeping the inode (best-effort:
    not every platform lets you open a directory)."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn) -> None:
    """THE crash-safe write sequence — temp file, ``write_fn(f)`` produces
    the bytes, flush + fsync, rename over ``path``, directory fsync. A
    crash at any point leaves either the previous file or an ignored temp,
    never a truncated ``path``. Envelope snapshots and graph npz snapshots
    both ride this one copy so durability fixes can't drift apart."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # crash-path hygiene for tests/retries
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fsync_dir(path)


def write_snapshot_file(path: str, snap: dict) -> int:
    """Atomically persist ``snap``: temp file + fsync + rename, payload
    checksummed in the header. Returns the bytes written."""
    payload = dumps(snap)
    digest = hashlib.sha256(payload).hexdigest()
    oplog = snap.get("oplog") or {}
    watermark = int(oplog.get("watermark", snap.get("oplog_position", 0)) or 0)
    floor = oplog.get("commit_floor")
    header = b"%s %s %d %s\n" % (
        _MAGIC,
        digest.encode(),
        watermark,
        (b"-" if floor is None else repr(float(floor)).encode()),
    )

    def _write(f):
        f.write(header)
        f.write(payload)

    atomic_write(path, _write)
    return len(header) + len(payload)


def _parse_header(line: bytes) -> Optional[dict]:
    parts = line.strip().split(b" ")
    if len(parts) != 4 or parts[0] != _MAGIC:
        return None
    try:
        return {
            "checksum": parts[1].decode(),
            "watermark": int(parts[2]),
            "commit_floor": None if parts[3] == b"-" else float(parts[3]),
        }
    except (ValueError, UnicodeDecodeError):
        return None


def read_snapshot_header(path: str) -> Optional[dict]:
    """The ``(watermark, commit_floor, checksum)`` header of a v2 snapshot
    WITHOUT reading the payload — the trimmer's clamp reads this on every
    GC cycle. None for legacy/garbled files (they contribute no floor: a
    file the restore path would skip must not pin the log forever)."""
    try:
        with open(path, "rb") as f:
            return _parse_header(f.readline(256))
    except OSError:
        return None


def read_snapshot_file(path: str) -> dict:
    """Load + verify a snapshot. Raises :class:`CorruptSnapshotError` for
    anything untrustworthy; ``OSError`` passes through for a missing file."""
    with open(path, "rb") as f:
        first = f.readline(256)
        header = _parse_header(first)
        if header is not None:
            payload = f.read()
            digest = hashlib.sha256(payload).hexdigest()
            if digest != header["checksum"]:
                raise CorruptSnapshotError(
                    f"{path}: checksum mismatch (torn write?) — "
                    f"header {header['checksum'][:12]}…, payload {digest[:12]}…"
                )
        else:
            payload = first + f.read()  # legacy v1: bare serialized dict
    try:
        snap = loads(payload)
    except Exception as e:  # noqa: BLE001 — any decode failure is corruption
        raise CorruptSnapshotError(f"{path}: undecodable payload: {e!r}") from e
    if not isinstance(snap, dict):
        raise CorruptSnapshotError(f"{path}: payload is not a snapshot dict")
    return snap


# ---------------------------------------------------------------- state
class DurableHubState:
    """Builds/consumes the epoch-consistent snapshot dict. Pure functions
    over the existing :class:`HubCheckpoint` body — cluster/oplog objects
    are optional so a standalone (non-cluster) hub snapshots the same way
    with epoch 0 and watermark from its log store."""

    @staticmethod
    def snapshot(
        hub,
        *,
        reader=None,
        log_store=None,
        member=None,
        router=None,
        rpc_hub=None,
    ) -> dict:
        from . import HubCheckpoint  # late: __init__ imports this module

        # watermark FIRST, hub state second — see the consistency note in
        # the module docstring (tail replay is at-least-once, never lossy)
        if reader is not None:
            watermark = int(reader.watermark)
            commit_floor = reader._last_commit_time
        elif log_store is not None:
            watermark = int(log_store.last_index())
            commit_floor = None
        else:
            watermark = 0
            commit_floor = None
        if commit_floor is None:
            # no processed-record timestamp to anchor on: the snapshot
            # moment itself is the floor (entries above the watermark are
            # appended at/after now, modulo cross-host clock skew — the
            # trimmer's max_age slack absorbs reasonable skew)
            commit_floor = time.time()
        snap = HubCheckpoint.snapshot(hub, oplog_position=watermark)
        snap["oplog"] = {"watermark": watermark, "commit_floor": float(commit_floor)}
        smap = None
        if member is not None:
            smap = member.shard_map
        elif router is not None:
            smap = router.shard_map
        if smap is not None:
            snap["cluster"] = {
                "epoch": int(smap.epoch),
                "member_id": getattr(member, "member_id", None),
                "shard_map": smap.to_wire(),
            }
        if rpc_hub is not None:
            snap["subscriptions"] = DurableHubState.snapshot_subscriptions(rpc_hub)
        return snap

    @staticmethod
    def snapshot_subscriptions(rpc_hub) -> List[dict]:
        """Every live inbound ``$sys-c`` subscription this server holds:
        which peer, which call shape, at which version. The links die with
        the process — clients re-subscribe on reconnect — but the record
        makes the restore report honest about what was being served and
        gives the auditor a before/after population to compare."""
        from ..utils.serialization import encode

        subs: List[dict] = []
        for ref, peer in list(getattr(rpc_hub, "peers", {}).items()):
            for call in list(getattr(peer, "inbound_calls", {}).values()):
                computed = getattr(call, "computed", None)
                message = getattr(call, "message", None)
                if computed is None or message is None:
                    continue
                try:
                    args = encode(loads(message.argument_data))
                except Exception:  # noqa: BLE001 — unserializable: count, don't die
                    args = None
                subs.append(
                    {
                        "peer": ref,
                        "s": message.service,
                        "m": message.method,
                        "a": args,
                        "v": computed.version.format(),
                    }
                )
        return subs

    @staticmethod
    def cluster_of(snap: dict) -> Dict[str, Any]:
        return snap.get("cluster") or {"epoch": 0, "member_id": None, "shard_map": None}

    @staticmethod
    def watermark_of(snap: dict) -> int:
        oplog = snap.get("oplog") or {}
        return int(oplog.get("watermark", snap.get("oplog_position", 0)) or 0)
