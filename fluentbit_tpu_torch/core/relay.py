"""The forward input's dedup ledger.

The port's own copy of ``DedupLedger`` from
``fluentbit_tpu/core/relay.py`` in its in-memory form (``root=None``):
a map chunk-id → [absorbed-at, absorb-count] with a retry-window TTL.
The forward input records each chunk id the first time its records are
absorbed and acks a redelivery of the same id inside the window without
absorbing it again. The durable form (an fstore sidecar under a storage
path) waits for the port's storage; asking for it raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["DedupLedger"]


class DedupLedger:
    """Chunk-id ledger with a retry-window TTL, kept in memory:
    in-process redelivery dedups, a restart forgets (the durability the
    chunks themselves have without filesystem storage). A count above 1
    in ``snapshot`` is a double absorb."""

    def __init__(self, root: Optional[str] = None, ttl: float = 300.0,
                 clock=time.time):
        if root:
            raise ValueError(
                "forward: a durable dedup ledger (storage.path) is not "
                "ported; unset the service's storage.path or dedup")
        self.ttl = float(ttl)
        self.clock = clock
        self._lock = threading.Lock()
        self._seen: Dict[str, List[float]] = {}  # id -> [ts, count]
        self.dedup_hits = 0

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
        """Record one absorb of ``chunk_id`` (before the caller acks)."""
        now = self.clock()
        with self._lock:
            self._gc(self._seen, now, self.ttl)
            rec = self._seen.get(chunk_id)
            if rec is None:
                self._seen[chunk_id] = [now, 1]
            else:
                rec[1] += 1  # a double absorb: kept visible, never hidden

    def size(self) -> int:
        with self._lock:
            return len(self._seen)

    def snapshot(self) -> Dict[str, int]:
        """chunk id → absorb count."""
        with self._lock:
            return {cid: rec[1] for cid, rec in self._seen.items()}
