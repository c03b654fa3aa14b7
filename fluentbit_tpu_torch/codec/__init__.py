from .msgpack import EventTime, ExtType, Unpacker, packb, unpackb
from .events import (LogEvent, decode_events, encode_event, encode_events,
                     iter_events, reencode_event)
from .chunk import CHUNK_TARGET_SIZE, Chunk, ChunkPool

__all__ = [
    "packb", "unpackb", "Unpacker", "ExtType", "EventTime",
    "LogEvent", "encode_event", "encode_events", "decode_events",
    "iter_events", "reencode_event",
    "Chunk", "ChunkPool", "CHUNK_TARGET_SIZE",
]
