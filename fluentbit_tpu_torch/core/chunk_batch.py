"""The raw chunk path's chunk view and its double-buffered staging pipeline.

The port's counterpart of ``fluentbit_tpu/core/chunk_batch.py``.
``RawChunk`` carries one append's encoded bytes along the chain of raw
filters: the record count one filter finds travels to the next as its
walk hint. ``double_buffered`` overlaps the host staging of segment N+1
with the device work of segment N: ``dispatch`` launches a segment's
kernel and returns a device tensor without waiting, and ``collect``
reads a result back (``.cpu()``) only once the next segment has been
staged and launched, so each readback runs one segment behind its
launch. On the CPU the same loop runs in order at no extra cost.

Staging buffers must not be reused while an earlier segment's
non-blocking copy may still read them: each segment stages into buffers
of its own (pinned tensors from torch's caching host allocator, which
holds a block until the copy that read it has finished).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

__all__ = ["RawChunk", "double_buffered", "segment_bounds"]


class RawChunk:
    """One append's raw chunk bytes on the chain of raw filters.

    data    : the encoded records (bytes, or a view a filter returned)
    tag     : the append's routing tag
    n       : the record count, or None until a filter finds it
    src     : the appending InputInstance
    engine  : the owning engine
    """

    __slots__ = ("data", "tag", "n", "src", "engine")

    def __init__(self, data, tag: str, n: Optional[int] = None,
                 src=None, engine=None):
        self.data = data
        self.tag = tag
        self.n = n
        self.src = src
        self.engine = engine

    def replace(self, data, n: Optional[int]) -> None:
        """Swap in a filter's output (its count may be unknown again)."""
        self.data = data
        self.n = n

    def as_bytes(self) -> bytes:
        """The chunk as ``bytes``, materialising a view once."""
        if not isinstance(self.data, bytes):
            self.data = bytes(self.data)
        return self.data


def segment_bounds(n: int, seg_records: int) -> List[tuple]:
    """Split ``n`` records into [start, end) segments of at most
    ``seg_records`` (the double buffer's grain)."""
    if seg_records <= 0 or n <= seg_records:
        return [(0, n)]
    return [(s, min(s + seg_records, n))
            for s in range(0, n, seg_records)]


def _readback(result: Any) -> Any:
    if isinstance(result, torch.Tensor):
        return result.cpu().numpy()
    return np.asarray(result)


def double_buffered(stage_iter: Iterable[Any],
                    dispatch: Callable[[Any], Any],
                    collect: Optional[Callable[[Any], Any]] = None,
                    depth: int = 2) -> List[Any]:
    """Run the staging/kernel pipeline with ``depth`` segments in flight
    (at least 2, the classic double buffer).

    ``stage_iter`` stages one segment on the host per ``__next__``;
    ``dispatch`` launches its device work and returns without waiting
    (a CUDA tensor); ``collect`` waits for a dispatched result and
    brings it to the host (default: ``.cpu().numpy()``). The loop
    dispatches segment i, stages segment i+1 while i's kernel runs,
    then collects the oldest segment once ``depth`` are in flight.
    Returns the collected results in segment order. An exception from
    any of the three propagates at once; segments still in flight are
    dropped unread."""
    if collect is None:
        collect = _readback
    depth = max(depth, 2)
    out: List[Any] = []
    pending: deque = deque()
    for staged in stage_iter:
        pending.append(dispatch(staged))
        if len(pending) >= depth:
            out.append(collect(pending.popleft()))
    while pending:
        out.append(collect(pending.popleft()))
    return out
