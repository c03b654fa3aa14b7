"""Priority bucket queue and the engine's event priorities.

The port's own copy of ``BucketQueue`` and the priorities of
``fluentbit_tpu/core/bucket_queue.py`` (its deficit-fair queue belongs
to the qos plane, which the port does not have yet).

Reference: include/fluent-bit/flb_bucket_queue.h (N FIFO buckets, the
lowest priority number served first) and flb_engine_macros.h:60-79 — 8
priorities, scheduler, timers and shutdown at the top (0), network at 1,
flush at 2. The engine queues its ready callbacks here and drains them
in priority order, so a retry timer that fires during a burst of flush
spawns goes first.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, List

PRIORITY_COUNT = 8
PRIORITY_TOP = 0                      # scheduler / timers / shutdown
PRIORITY_NETWORK = 1
PRIORITY_FLUSH = PRIORITY_NETWORK + 1
PRIORITY_DEFAULT = PRIORITY_COUNT - 1


class BucketQueue:
    """N FIFO buckets; ``pop()`` serves the lowest-numbered non-empty
    bucket (flb_bucket_queue_add / pop_min). A priority out of range
    clamps to the nearest bucket."""

    __slots__ = ("_buckets", "_size")

    def __init__(self, priorities: int = PRIORITY_COUNT):
        self._buckets: List[deque] = [deque() for _ in range(priorities)]
        self._size = 0

    def add(self, priority: int, item: Any) -> None:
        priority = min(max(priority, 0), len(self._buckets) - 1)
        self._buckets[priority].append(item)
        self._size += 1

    def pop(self) -> Any:
        for bucket in self._buckets:
            if bucket:
                self._size -= 1
                return bucket.popleft()
        raise IndexError("pop from empty BucketQueue")

    def drain(self) -> Iterator[Any]:
        while self._size:
            yield self.pop()

    def __len__(self) -> int:
        return self._size

    def __bool__(self) -> bool:
        return self._size > 0
