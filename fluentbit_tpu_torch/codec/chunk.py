"""Tagged chunks — the unit of buffering, routing and flushing.

The port's own copy of ``fluentbit_tpu/codec/chunk.py``, trimmed (no
copy witness, no qos stamps). Log and metrics chunks share a pool, keyed
by event type, tag and route mask: a conditionally routed group of
records never merges into a chunk with other routes. A chunk carries an
id (the retry timers' and the storage's key), its creation time (the
delivery latency's start), the route mask, the names of its routes and
the name of the input whose pool made it (its storage stream), and the
storage header's pad byte. The pool
counts the bytes it holds, which input backpressure reads
(``pending_bytes``, ``pending_chunks``), and evicts its oldest chunks
for a ``memrb`` input (``evict_oldest``).

Reference semantics (src/flb_input_chunk.c): each input owns a pool of
chunks keyed by tag; appends go to the active chunk for that tag until it
reaches the ~2MB target size, at which point it is "locked"
(src/flb_input_chunk.c:3135) and a new chunk is opened. Dispatch walks
ready chunks and creates one flush per chunk and route.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

# Reference: chunks are locked once above ~2MB so flushes stay bounded.
CHUNK_TARGET_SIZE = 2 * 1024 * 1024

EVENT_TYPE_LOGS = "logs"
EVENT_TYPE_METRICS = "metrics"

_chunk_ids = itertools.count(1)


class Chunk:
    """A tagged, append-only buffer of concatenated msgpack events."""

    __slots__ = ("id", "tag", "event_type", "_parts", "_size", "records",
                 "created", "locked", "routes_mask", "route_names",
                 "in_name", "pad_byte")

    def __init__(self, tag: str, event_type: str = EVENT_TYPE_LOGS,
                 in_name: str = ""):
        self.id = next(_chunk_ids)
        self.tag = tag
        self.event_type = event_type
        # appended spans are kept as a part list and joined lazily at
        # get_bytes(): append is O(1) instead of a bytearray grow-copy
        self._parts: List[bytes] = []
        self._size = 0
        self.records = 0
        self.created = time.time()
        self.locked = False
        # the outputs' bits of a conditionally routed chunk (0: route by
        # tag) and, stamped at the split, their names, which dispatch
        # resolves first
        self.routes_mask = 0
        self.route_names: Optional[Tuple[str, ...]] = None
        self.in_name = in_name
        # the storage header's pad byte (the reference's qos priority
        # class): 0 for the port's chunks, kept from a recovered file
        self.pad_byte = 0

    @property
    def size(self) -> int:
        return self._size

    @property
    def buf(self) -> bytes:
        return self.get_bytes()

    @buf.setter
    def buf(self, payload) -> None:
        """Adopt a whole payload (a chunk recovered from storage)."""
        self._parts = [bytes(payload)]
        self._size = len(self._parts[0])

    def append(self, data: bytes, n_records: int) -> None:
        if self.locked:
            raise RuntimeError("append to locked chunk")
        self._parts.append(bytes(data))
        self._size += len(data)
        self.records += n_records
        if self._size >= CHUNK_TARGET_SIZE:
            self.locked = True

    def get_bytes(self) -> bytes:
        if len(self._parts) == 1:
            return self._parts[0]
        joined = b"".join(self._parts)
        if self.locked:
            self._parts = [joined]
        return joined


class ChunkPool:
    """Per-input chunk pool keyed by (event_type, tag).

    Reference: ht_log_chunks hashtable per input (src/flb_input_log.c:1524);
    input_chunk_get selects/creates the active chunk
    (src/flb_input_chunk.c:3000). Callers serialize access (the engine's
    ingest lock).
    """

    def __init__(self, in_name: str = "") -> None:
        self.in_name = in_name
        self._active: Dict[tuple, Chunk] = {}
        self._ready: List[Chunk] = []
        self.total_bytes = 0

    def append(self, tag: str, data: bytes, n_records: int,
               event_type: str = EVENT_TYPE_LOGS,
               routes_mask: int = 0) -> Chunk:
        key = (event_type, tag, routes_mask)
        chunk = self._active.get(key)
        if chunk is None:
            chunk = self._active[key] = Chunk(tag, event_type, self.in_name)
            chunk.routes_mask = routes_mask
        chunk.append(data, n_records)
        self.total_bytes += len(data)
        if chunk.locked:
            self._ready.append(chunk)
            del self._active[key]
        return chunk

    def evict_oldest(self, bytes_needed: int) -> List[Chunk]:
        """memrb eviction (src/flb_input_chunk.c:2936-2966): drop the
        oldest buffered chunks, the locked ones first, until
        ``bytes_needed`` bytes are freed. Returns the dropped chunks."""
        dropped = []
        freed = 0
        while freed < bytes_needed and self._ready:
            c = self._ready.pop(0)
            freed += c.size
            self.total_bytes -= c.size
            dropped.append(c)
        if freed < bytes_needed:
            for key in sorted(self._active,
                              key=lambda k: self._active[k].created):
                if freed >= bytes_needed:
                    break
                c = self._active.pop(key)
                freed += c.size
                self.total_bytes -= c.size
                dropped.append(c)
        return dropped

    def drain(self) -> List[Chunk]:
        """Take all flushable chunks (locked + currently active non-empty)."""
        out = list(self._ready)
        self._ready.clear()
        for key in list(self._active):
            c = self._active.pop(key)
            if c.records > 0:
                c.locked = True
                out.append(c)
        for c in out:
            self.total_bytes -= c.size
        if not self._active and not self._ready:
            self.total_bytes = 0
        return out

    @property
    def pending_bytes(self) -> int:
        return self.total_bytes

    @property
    def pending_chunks(self) -> int:
        return len(self._ready) + sum(1 for c in self._active.values()
                                      if c.records)
