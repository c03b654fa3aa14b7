"""Relay state: the forward input's dedup ledger, the forward output's
chunk id and partition spool.

The port's own copy of ``fluentbit_tpu/core/relay.py``:

- :func:`stable_chunk_id`, the forward hop's chunk id: a digest of the
  tag and the uncompressed entry stream, so a resend of the same chunk
  (a reconnect, a backoff, a spool replay) carries the same id;
- :class:`DedupLedger`: chunk id → [absorbed-at, absorb-count] with a
  retry-window TTL. The forward input records each chunk id the first
  time its records are absorbed, before it acks, and acks a redelivery
  of the same id inside the window without absorbing it again. Under
  the service's ``storage.path`` the ledger is durable: an fstore JSON
  sidecar (stream ``forward-dedup``, file ``ledger``), written whole and
  renamed into place at each record, in the reference's layout, so a
  ledger either package wrote reads in the other and a restart still
  dedups; without it the ledger is in memory;
- :class:`ForwardSpool`, where the forward output parks a packed chunk
  when every upstream refuses (a partition), with a record-offset
  sidecar (``core.sidecar``) and a JSON envelope (tag, chunk id, record
  count), replayed in spool order on heal.

The reference meters the spool against the chunk tenant's storage quota
(``qos.admit_storage``); for a chunk of no tenant that declares a
storage limit that admits, and the port has no qos plane and no tenant
stamps, so the port's spool is unmetered, as the reference's is without
tenants.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .fstore import FStore, FStoreFile
from .sidecar import SIDECAR_SUFFIX, SidecarWriter, read_sidecar

__all__ = ["DedupLedger", "ForwardSpool", "stable_chunk_id"]


def stable_chunk_id(tag: str, blob: bytes) -> str:
    """The forward hop's chunk id: a digest of (tag, entry stream) over
    the uncompressed packed entries, so the id survives compression
    settings, reconnects, backoff resends and spool replays."""
    h = hashlib.sha256()
    h.update(tag.encode("utf-8", "replace"))
    h.update(b"\x00")
    h.update(blob)
    return h.hexdigest()[:32]


class DedupLedger:
    """Chunk-id ledger with a retry-window TTL (reference
    fluentbit_tpu/core/relay.py:62-151). ``root`` (the storage path)
    makes it durable; ``root=None`` keeps it in memory, where a restart
    forgets, the durability the chunks themselves have without
    filesystem storage. The meta layout::

        {"absorbed": {"<chunk-id>": [<absorbed-at>, <absorb-count>]}}

    A count above 1 in ``snapshot`` is a double absorb."""

    STREAM = "forward-dedup"

    def __init__(self, root: Optional[str] = None, ttl: float = 300.0,
                 clock=time.time):
        self.ttl = float(ttl)
        self.clock = clock
        self._lock = threading.Lock()
        self._file: Optional[FStoreFile] = None
        self._seen: Dict[str, List[float]] = {}  # id -> [ts, count]
        self.dedup_hits = 0
        if root:
            self._file = FStore(root).stream(self.STREAM).create("ledger")
            now = self.clock()
            absorbed = self._file.meta().get("absorbed") or {}
            for cid, rec in absorbed.items():
                try:
                    ts, count = float(rec[0]), int(rec[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if now - ts <= self.ttl:
                    self._seen[str(cid)] = [ts, count]

    @staticmethod
    def _gc(seen: Dict[str, List[float]], now: float, ttl: float) -> None:
        dead = [cid for cid, rec in seen.items() if now - rec[0] > ttl]
        for cid in dead:
            del seen[cid]

    def seen(self, chunk_id: str) -> bool:
        """True when this chunk id was absorbed inside the TTL window:
        the caller acks without absorbing (a redelivery)."""
        now = self.clock()
        with self._lock:
            self._gc(self._seen, now, self.ttl)
            hit = chunk_id in self._seen
            if hit:
                self.dedup_hits += 1
        return hit

    def record(self, chunk_id: str) -> None:
        """Record one absorb of ``chunk_id``, durably when the ledger has
        a root, before the caller acks: an ack whose record died with
        the process would make the next resend a double absorb."""
        now = self.clock()
        with self._lock:
            self._gc(self._seen, now, self.ttl)
            rec = self._seen.get(chunk_id)
            if rec is None:
                self._seen[chunk_id] = [now, 1]
            else:
                rec[1] += 1  # a double absorb: kept visible, never hidden
            snap = {cid: [r[0], r[1]] for cid, r in self._seen.items()}
        if self._file is not None:
            self._file.set_meta({"absorbed": snap}, durable=True)

    def size(self) -> int:
        with self._lock:
            return len(self._seen)

    def snapshot(self) -> Dict[str, int]:
        """chunk id → absorb count."""
        with self._lock:
            return {cid: rec[1] for cid, rec in self._seen.items()}


class ForwardSpool:
    """Partition-time buffer for the forward output.

    One spooled chunk is one fstore file holding the packed entry
    stream, a ``.offs`` record-offset sidecar and a JSON meta sidecar
    with the wire envelope (tag, chunk id, record count, tenant and
    priority stamps). Files are named by an increasing sequence, so
    replay keeps spool order.
    """

    STREAM = "forward-spool"

    def __init__(self, root: str):
        self._stream = FStore(root).stream(self.STREAM)
        self._lock = threading.Lock()
        seq = 0
        for f in self._stream.files():
            name = f.name.split(".", 1)[0]
            if name.isdigit():
                seq = max(seq, int(name) + 1)
        self._seq = seq

    def put(self, tag: str, blob: bytes, ends: List[int], meta: dict
            ) -> FStoreFile:
        """Spool one packed entry stream, its offset table and its
        envelope. The payload is flushed before the sidecars (replay
        copes with either file being ahead)."""
        with self._lock:
            name = "%012d" % self._seq
            self._seq += 1
        f = self._stream.create(name)
        with open(f.path, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        w = SidecarWriter(f.path + SIDECAR_SUFFIX)
        w.append_ends(len(blob), ends)
        w.finalize()
        f.set_meta(dict(meta, n=len(ends)), durable=True)
        return f

    def pending(self) -> List[FStoreFile]:
        """Spooled chunks in replay (spool) order."""
        return [f for f in self._stream.files()
                if not f.name.endswith(SIDECAR_SUFFIX)]

    @staticmethod
    def load(f: FStoreFile) -> Optional[Tuple[bytes, int, dict]]:
        """Map one spooled chunk for replay: ``(payload, n, meta)``. The
        record count comes from the ``.offs`` table when it validates,
        else from the envelope; a file with neither is None (the caller
        drops it: it cannot be framed)."""
        meta = f.meta()
        try:
            with open(f.path, "rb") as fh:
                size = os.fstat(fh.fileno()).st_size
                if size == 0:
                    return None
                mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None
        try:
            n = None
            got = read_sidecar(f.path + SIDECAR_SUFFIX, size)
            if got is not None and got[1].size:
                n = int(got[1].size)
            if n is None:
                n = int(meta.get("n") or 0)
            if n <= 0:
                return None
            return bytes(mm), n, meta
        finally:
            mm.close()

    @staticmethod
    def drop(f: FStoreFile) -> None:
        """Delete a delivered (acked) spool chunk and its sidecars."""
        try:
            os.unlink(f.path + SIDECAR_SUFFIX)
        except OSError:
            pass
        f.delete()
