"""Log event codec — Fluent Bit log event format V2.

The port's own copy of ``fluentbit_tpu/codec/events.py``. ``decode_events``,
``iter_events``, ``encode_event`` and ``reencode_event`` run the port's
event codec extension (``csrc/codec_py.cpp``, loaded by
``_native_codec``), as the reference's run its C codec. Its
``FallbackError`` (an ext type other than EventTime, or a value type the
packer does not know) is the one case the plain Python versions
(``decode_events_plain``, ``pack_event_plain``) take; a failed build of
the extension raises. ``fast_count_records`` counts through the port's
host codec (``fluentbit_tpu_torch.native``).

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
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import _native_codec
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


_EMPTY_META: Dict[str, Any] = {}


def pack_event_plain(timestamp: Any, metadata: Dict[str, Any],
                     body: Dict[str, Any]) -> bytes:
    """The plain Python packer of one V2 event ``[[ts, meta], body]``:
    the extension's ``pack_event`` gives the same bytes."""
    return packb([[timestamp, metadata], body])


def encode_event(
    body: Dict[str, Any],
    timestamp: Any = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> bytes:
    """Encode one V2 log event to msgpack bytes."""
    if timestamp is None:
        timestamp = now_event_time()
    mod = _native_codec.load()
    try:
        return mod.pack_event(timestamp, metadata or _EMPTY_META, body)
    except mod.FallbackError:  # a type outside the packer's set
        return pack_event_plain(timestamp, metadata or {}, body)


def encode_events(events: List[Tuple[Any, Dict[str, Any]]]) -> bytes:
    """Encode (timestamp, body) pairs into a concatenated V2 buffer."""
    return b"".join(encode_event(body, ts) for ts, body in events)


def decode_events(buf) -> List[LogEvent]:
    """Decode all log events in a concatenated msgpack buffer.

    Accepts V2 ``[[ts, meta], body]`` and legacy ``[ts, body]`` records.
    Each returned event carries its raw byte span (``event.raw``). A torn
    trailing record ends the list. Nesting past 512 levels raises
    ValueError.
    """
    mod = _native_codec.load()
    try:
        return mod.decode_events(buf)
    except mod.FallbackError:  # an ext type other than EventTime
        return decode_events_plain(buf)


def iter_events(buf) -> Iterator[LogEvent]:
    """Iterate the buffer's events. The whole buffer decodes before the
    first yield (chunks are bounded at ~2 MB), as in the reference with
    its codec loaded."""
    yield from decode_events(buf)


def decode_events_plain(buf) -> List[LogEvent]:
    """The plain Python decoder (``Unpacker``): the extension's
    ``decode_events`` gives the same events."""
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
    mod = _native_codec.load()
    try:
        return mod.pack_event(ev.timestamp, ev.metadata, ev.body)
    except mod.FallbackError:  # a type outside the packer's set
        return pack_event_plain(ev.timestamp, ev.metadata, ev.body)
