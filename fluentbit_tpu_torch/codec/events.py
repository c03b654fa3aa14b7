"""Log event codec — Fluent Bit log event format V2.

The port's own copy of ``fluentbit_tpu/codec/events.py``: the decoder and
encoder are pure Python (the bytes are the reference's —
tests/test_torch_codec.py); ``fast_count_records`` counts through the
port's host codec (``fluentbit_tpu_torch.native``).

A log event is msgpack ``[[timestamp, metadata-map], body-map]``
(reference: include/fluent-bit/flb_log_event.h:29-62). Legacy (Forward/V1)
events are ``[timestamp, body-map]``; the decoder accepts both and the
encoder emits V2.

The decoder exposes per-record raw byte spans so filters can re-emit
surviving records byte-identical (the grep contract,
plugins/filter_grep/grep.c:286-392).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .msgpack import EventTime, Unpacker, packb


@dataclass
class LogEvent:
    """A decoded log event."""

    timestamp: Any  # EventTime | int | float
    body: Dict[str, Any] = field(default_factory=dict)
    metadata: Dict[str, Any] = field(default_factory=dict)
    # raw msgpack span of this record within the source buffer (if decoded)
    raw: Optional[bytes] = None

    @property
    def ts_float(self) -> float:
        return float(self.timestamp)


def now_event_time() -> EventTime:
    return EventTime.from_float(_time.time())


def encode_event(
    body: Dict[str, Any],
    timestamp: Any = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> bytes:
    """Encode one V2 log event to msgpack bytes."""
    if timestamp is None:
        timestamp = now_event_time()
    return packb([[timestamp, metadata or {}], body])


def decode_events(buf: bytes) -> List[LogEvent]:
    """Decode all log events in a concatenated msgpack buffer.

    Accepts V2 ``[[ts, meta], body]`` and legacy ``[ts, body]`` records.
    Each returned event carries its raw byte span (``event.raw``).
    """
    events: List[LogEvent] = []
    u = Unpacker(buf)
    pos = 0
    for obj in u:
        end = u.tell()
        raw = buf[pos:end]
        pos = end
        events.append(_to_event(obj, raw))
    return events


def count_records(buf: bytes) -> int:
    """Count log records by a Python decode (flb_mp_count_log_records,
    reference src/flb_mp.c). Raises ValueError on malformed msgpack."""
    n = 0
    for _ in Unpacker(buf):
        n += 1
    return n


def fast_count_records(buf) -> Optional[int]:
    """Count records with the host codec, no Python-object decode. The
    codec rejects what the Python decoder may still take (more than 64
    levels of nesting): then the Python count decides. None when neither
    can count it (malformed msgpack, or nesting too deep for Python)."""
    from .. import native

    if not isinstance(buf, bytes):
        buf = bytes(buf)
    n = native.count_records(buf)
    if n is not None:
        return n
    try:
        return count_records(buf)
    except (ValueError, RecursionError):
        return None


def _to_event(obj: Any, raw: Optional[bytes] = None) -> LogEvent:
    if not isinstance(obj, list) or not obj:
        raise ValueError(f"invalid log event: {obj!r}")
    header = obj[0]
    if isinstance(header, list):
        # V2: [[ts, metadata], body]
        ts = header[0] if header else 0
        meta = header[1] if len(header) > 1 and isinstance(header[1], dict) else {}
        body = obj[1] if len(obj) > 1 and isinstance(obj[1], dict) else {}
        return LogEvent(timestamp=ts, body=body, metadata=meta, raw=raw)
    # legacy: [ts, body]
    ts = header
    body = obj[1] if len(obj) > 1 and isinstance(obj[1], dict) else {}
    return LogEvent(timestamp=ts, body=body, metadata={}, raw=raw)


def reencode_event(ev: LogEvent) -> bytes:
    """Re-encode a (possibly modified) event as V2."""
    return packb([[ev.timestamp, ev.metadata], ev.body])
