"""Record-offset sidecar: the END offsets of a payload's records.

The port's own copy of ``fluentbit_tpu/core/sidecar.py``. A filesystem
chunk file (``core.storage``) and a spooled forward chunk
(``core.relay.ForwardSpool``) carry their record boundary table beside
them, written as the payload is written, so a replay takes the record
count from the table without walking the msgpack payload.

Layout (``<file>.offs``)::

    FBTO | ver u8 | state u8 | crc32 u32le      (header, 10 bytes)
    u64le record END offsets, strictly increasing, relative to the
    payload start

``state`` 0 = open (entries advisory: a crash may have torn either
file, the reader validates), 1 = finalized (``crc`` covers the entry
bytes). A partial trailing entry is truncated at the last full 8 bytes;
entries past the payload length are dropped; any monotonicity violation
invalidates the whole table, and the caller falls back to what it knows
otherwise. The table can only ever spare a walk, never change a result.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Optional, Tuple

import numpy as np

__all__ = ["SIDECAR_SUFFIX", "SidecarWriter", "sidecar_path",
           "read_sidecar", "STATE_OPEN", "STATE_FINAL"]

MAGIC = b"FBTO"
VERSION = 1
STATE_OPEN = 0
STATE_FINAL = 1

_HEAD = struct.Struct("<4sBBI")  # magic, ver, state, crc32(entries)

SIDECAR_SUFFIX = ".offs"


def sidecar_path(chunk_path: str) -> str:
    """The offset table beside a chunk file."""
    return chunk_path + SIDECAR_SUFFIX


class SidecarWriter:
    """Incremental offset-table writer bound to one chunk stream file.

    ``append_ends`` takes the END offsets of the records inside ONE
    appended span, relative to that span; the writer rebases them onto
    the running payload length so the persisted entries are absolute
    within the payload. Callers flush the chunk data first, then the
    sidecar — replay tolerates either file being ahead of the other.
    """

    __slots__ = ("path", "_f", "_base", "_crc", "_dead")

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HEAD.pack(MAGIC, VERSION, STATE_OPEN, 0))
        self._f.flush()
        self._base = 0
        self._crc = 0
        self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def append_ends(self, span_len: int,
                    ends: Optional[Iterable[int]]) -> None:
        """Record one appended span's record END offsets.

        ``ends`` None means the caller could not produce a boundary
        table for this span (native scanner unavailable / undecodable
        bytes): the sidecar is now incomplete FOREVER for this chunk,
        so it is unlinked rather than left lying — a partial table
        that silently skips a span would replay the wrong records.
        """
        if self._dead:
            return
        if ends is None:
            self.kill()
            return
        base = self._base
        payload = b"".join(
            struct.pack("<q", base + int(e)) for e in ends)
        if payload:
            self._f.write(payload)
            self._f.flush()
            self._crc = zlib.crc32(payload, self._crc)
        self._base = base + span_len

    def finalize(self) -> None:
        """Stamp state=final + entry CRC (drain time, with the chunk's
        own CRC stamp) and close the handle."""
        if self._dead:
            return
        self._f.flush()
        self._f.seek(0)
        self._f.write(_HEAD.pack(MAGIC, VERSION, STATE_FINAL,
                                 self._crc & 0xFFFFFFFF))
        self._f.close()
        self._dead = True

    def close(self) -> None:
        if not self._dead:
            try:
                self._f.close()
            except OSError:
                pass
            self._dead = True

    def kill(self) -> None:
        """Abandon the sidecar: close and unlink (incomplete tables
        must not survive — see append_ends)."""
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def read_sidecar(path: str, payload_len: int
                 ) -> Optional[Tuple[int, np.ndarray, bool]]:
    """Load + validate an offset table against a payload length.

    Returns ``(state, ends, trusted_layout)`` or None when the file is
    absent/unusable. ``ends`` holds only entries that are strictly
    increasing, positive, and <= payload_len (a torn trailing entry is
    truncated at the last full 8 bytes; entries past the payload are
    dropped — the chunk flush may have lost the bytes they describe).
    ``trusted_layout`` is True only when the sidecar is FINAL and its
    entry CRC matches — the caller may then skip the validation walk,
    provided the chunk payload itself passed its own CRC.

    Any monotonicity violation invalidates the WHOLE table (a bit flip
    in one entry says nothing about its neighbours): returns None and
    replay takes the decode walk.
    """
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if len(blob) < _HEAD.size:
        return None
    magic, ver, state, crc = _HEAD.unpack_from(blob)
    if magic != MAGIC or ver != VERSION:
        return None
    if state not in (STATE_OPEN, STATE_FINAL):
        # a state byte neither open nor final is corruption, not a
        # crash window — nothing else in the file can be believed
        return None
    body = blob[_HEAD.size:]
    body = body[: len(body) - (len(body) % 8)]
    trusted = False
    if state == STATE_FINAL:
        trusted = (zlib.crc32(body) & 0xFFFFFFFF) == crc
        if not trusted:
            # a FINAL sidecar with a bad CRC is corrupt, not torn:
            # nothing in it can be believed
            return None
    ends = np.frombuffer(body, dtype="<i8")
    if ends.size:
        if int(ends[0]) <= 0 or bool((np.diff(ends) <= 0).any()):
            return None
        keep = int(np.searchsorted(ends, payload_len, side="right"))
        if ends.size > keep:
            ends = ends[:keep]
            trusted = False  # the table outran the flushed payload
    return int(state), ends.astype(np.int64, copy=False), trusted
