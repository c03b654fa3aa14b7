"""Filesystem chunk storage: write-through, backlog replay, the DLQ.

The port's own copy of ``fluentbit_tpu/core/storage.py`` (reference
lib/chunkio's file chunks with CRC32, src/flb_storage.c, and
plugins/in_storage_backlog). The file layout is the reference's byte for
byte, so a root written by either package recovers in the other::

    <root>/streams/<input_name>/<chunk_id>-<8 hex>.flb   in-flight chunks
    <root>/dlq/<chunk_id>-<8 hex>.flb                   quarantined chunks
    <file>.offs                                        record-offset sidecar

Header (v2): ``FBTC | ver u8 | type u8 | state u8 | pad u8 | crc32 u32le |
tag_len u16le | routes_len u16le | route_names | tag``, then the payload
(concatenated msgpack events). v1 files have no routes field and route
by tag. Route names, not bit positions, survive an output reorder. State
0 = open (the CRC is not valid yet: a crash left the chunk un-finalized,
and its payload is still recovered up to the last whole record), 1 =
finalized (with ``storage.checksum``, the CRC of the payload must match;
a mismatch moves the file to ``dlq/<name>.corrupt``). The pad byte is
the reference's qos priority class (0 = unstamped, n + 1 = class n): the
port has no qos, so it writes 0 for its own chunks and writes a
recovered chunk's byte back unchanged when it quarantines it.

Appends are write-through (write + flush, so a crash loses at most the
last partial write); the CRC is stamped when the chunk is finalized at
drain time. The sidecar is written after each data flush; replay maps
the file and takes the record count from the table when it can (the
trust ladder of ``_replay_mmap``), else walks the payload
(``_replay_decode``). Both routes give the same chunk.
"""

from __future__ import annotations

import logging
import mmap as _mmap
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from .. import failpoints as _fp
from ..codec.chunk import EVENT_TYPE_LOGS, EVENT_TYPE_METRICS, Chunk
from . import sidecar as _sidecar

log = logging.getLogger("flb.storage")

MAGIC = b"FBTC"
VERSION = 2
STATE_OPEN = 0
STATE_FINAL = 1

# the reference's event type codes (traces, profiles and blobs have no
# chunks in the port, but their files read back with their type's name)
_TYPE_CODES = {EVENT_TYPE_LOGS: 0, EVENT_TYPE_METRICS: 1, "traces": 2,
               "profiles": 3, "blobs": 4}
_TYPE_NAMES = {v: k for k, v in _TYPE_CODES.items()}

_HEAD = struct.Struct("<4sBBBBIH")  # magic, ver, type, state, pad, crc, tag_len
_RLEN = struct.Struct("<H")  # v2: route-names blob length


def _routes_blob(chunk: Chunk) -> bytes:
    """The v2 route-names field: a conditionally split chunk persists its
    outputs' names; an empty blob routes by tag."""
    blob = "\n".join(chunk.route_names or ()).encode("utf-8")[:65535]
    return _RLEN.pack(len(blob)) + blob


def _header(chunk: Chunk, state: int, crc: int) -> bytes:
    tag = chunk.tag.encode("utf-8")
    return _HEAD.pack(MAGIC, VERSION,
                      _TYPE_CODES.get(chunk.event_type, 0), state,
                      chunk.pad_byte, crc, len(tag)) + _routes_blob(chunk)


class Storage:
    """Filesystem backend for chunk persistence and the DLQ.

    ``replay_sidecar_hits`` counts replays that took the record table
    from the sidecar (``replay_sidecar_trusted`` of them with no walk at
    all), ``replay_decode_walks`` the replays that walked the payload,
    and ``replay_seconds`` the wall of the backlog scans."""

    def __init__(self, path: str, checksum: bool = True):
        self.root = os.path.abspath(path)
        self.checksum = checksum
        self.streams_dir = os.path.join(self.root, "streams")
        self.dlq_dir = os.path.join(self.root, "dlq")
        os.makedirs(self.streams_dir, exist_ok=True)
        os.makedirs(self.dlq_dir, exist_ok=True)
        # chunk id → (open file or None once finalized, path)
        self._files: Dict[int, Tuple[Optional[object], str]] = {}
        self._quarantined: set = set()  # chunk ids already in the DLQ
        # chunk id → the sidecar's incremental writer
        self._sidecars: Dict[int, _sidecar.SidecarWriter] = {}
        self.replay_sidecar_hits = 0
        self.replay_sidecar_trusted = 0
        self.replay_decode_walks = 0
        self.replay_seconds = 0.0

    # -- write path --

    def _chunk_path(self, chunk: Chunk) -> str:
        d = os.path.join(self.streams_dir, chunk.in_name or "default")
        os.makedirs(d, exist_ok=True)
        # chunk ids restart with the process: the random suffix keeps a
        # new file from colliding with a recovered one
        return os.path.join(d, f"{chunk.id}-{os.urandom(4).hex()}.flb")

    def write_through(self, chunk: Chunk, data, offsets=None) -> None:
        """Persist one append at once (crash-safe up to this write).

        ``offsets``: the END offsets of the append's records, relative to
        the span, when the caller has them (the decoded path does); else
        the host codec scans them. Without a table the chunk's sidecar is
        abandoned and replay walks the payload."""
        if _fp.ACTIVE:
            # partial(n): a torn write, only the first n bytes persist
            d = _fp.fire("storage.append")
            if d is not None and d[0] == "partial":
                data = data[: d[1]]
        entry = self._files.get(chunk.id)
        if entry is None:
            path = self._chunk_path(chunk)
            f = open(path, "wb")
            f.write(_header(chunk, STATE_OPEN, 0))
            f.write(chunk.tag.encode("utf-8"))
            entry = self._files[chunk.id] = (f, path)
            self._sidecars[chunk.id] = _sidecar.SidecarWriter(
                _sidecar.sidecar_path(path))
        f = entry[0]
        f.write(data)
        if _fp.ACTIVE:
            # a crash here loses the buffered append: the window
            # write-through bounds
            _fp.fire("storage.flush")
        f.flush()
        # after the data flush: replay tolerates the table behind or
        # ahead of the payload
        writer = self._sidecars.get(chunk.id)
        if writer is not None and not writer.dead:
            writer.append_ends(len(data), self._span_ends(data, offsets))

    @staticmethod
    def _span_ends(data, offsets):
        """The span's record END offsets: the caller's, else the host
        codec's (None abandons the sidecar)."""
        if offsets is not None:
            return offsets
        from .. import native

        offs = native.scan_offsets(data)
        return None if offs is None else offs[1:]

    def finalize(self, chunk: Chunk) -> None:
        """Stamp the CRC and the finalized state (at drain time)."""
        entry = self._files.get(chunk.id)
        if entry is None or entry[0] is None:
            return
        if _fp.ACTIVE:
            # a crash here leaves the chunk open on disk: recovery must
            # still replay its whole payload
            _fp.fire("storage.finalize")
        f, path = entry
        crc = zlib.crc32(chunk.get_bytes()) & 0xFFFFFFFF \
            if self.checksum else 0
        f.flush()
        f.seek(0)
        f.write(_header(chunk, STATE_FINAL, crc))
        f.close()
        self._files[chunk.id] = (None, path)
        writer = self._sidecars.pop(chunk.id, None)
        if writer is not None:
            # stamped with the chunk's CRC: a finalized pair whose CRCs
            # both hold is what replay may trust outright
            writer.finalize()

    def is_tracked(self, chunk: Chunk) -> bool:
        """True when the chunk has a stream file (a crash or a stop leaves
        it to the next start's backlog)."""
        return chunk.id in self._files

    def delete(self, chunk: Chunk) -> None:
        """Drop the stream file once every route delivered the chunk."""
        entry = self._files.pop(chunk.id, None)
        if entry is None:
            return
        f, path = entry
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        writer = self._sidecars.pop(chunk.id, None)
        if writer is not None:
            writer.close()
        for p in (path, _sidecar.sidecar_path(path)):
            try:
                os.unlink(p)
            except OSError:
                pass

    def quarantine(self, chunk: Chunk) -> str:
        """The DLQ: write a rejected chunk (retries exhausted, an error, a
        stop with its flush undelivered) under ``dlq/``, once per chunk
        however many routes failed. Returns the file's path ("" for a
        chunk already there)."""
        if chunk.id in self._quarantined:
            return ""
        self._quarantined.add(chunk.id)
        path = os.path.join(self.dlq_dir,
                            f"{chunk.id}-{os.urandom(4).hex()}.flb")
        payload = chunk.get_bytes()
        crc = zlib.crc32(payload) & 0xFFFFFFFF if self.checksum else 0
        with open(path, "wb") as f:
            f.write(_header(chunk, STATE_FINAL, crc))
            f.write(chunk.tag.encode("utf-8"))
            f.write(payload)
        # a finalized sidecar, so reading a large DLQ walks nothing
        writer = _sidecar.SidecarWriter(_sidecar.sidecar_path(path))
        writer.append_ends(len(payload), self._span_ends(payload, None))
        writer.finalize()
        return path

    # -- read path (the backlog) --

    def _read_chunk_file(self, path: str) -> Chunk:
        with open(path, "rb") as f:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                raise ValueError("truncated header")
            magic, ver, tcode, state, pad, crc, tag_len = _HEAD.unpack(head)
            if magic != MAGIC or ver not in (1, VERSION):
                raise ValueError("bad magic/version")
            route_names = None
            if ver >= 2:
                (rlen,) = _RLEN.unpack(f.read(_RLEN.size))
                if rlen:
                    route_names = tuple(
                        f.read(rlen).decode("utf-8").split("\n"))
            tag = f.read(tag_len).decode("utf-8")
            got = self._replay_mmap(f, path, state, crc)
            if got is not None:
                payload, records = got
                self.replay_sidecar_hits += 1
            else:
                payload, records = self._replay_decode(f, state, crc)
                self.replay_decode_walks += 1
        chunk = Chunk(tag, _TYPE_NAMES.get(tcode, EVENT_TYPE_LOGS),
                      os.path.basename(os.path.dirname(path)))
        chunk.buf = payload
        chunk.records = records
        chunk.locked = True
        chunk.route_names = route_names
        chunk.pad_byte = pad
        return chunk

    def _replay_decode(self, f, state: int, crc: int):
        """Read the payload, check its CRC, walk every record to count
        them and cut a torn tail: the reference that the mmap route
        matches."""
        payload = f.read()
        if state == STATE_FINAL and self.checksum and crc:
            if _fp.ACTIVE:
                # return(err) takes a sound chunk down the corrupt path
                _fp.fire("storage.crc_verify")
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("crc mismatch")
        from ..codec.msgpack import Unpacker

        # a crash mid-write can leave a partial last event in an open
        # file: cut at the last whole record
        u = Unpacker(payload)
        records = 0
        for _ in u:
            records += 1
        if u.tell() != len(payload):
            payload = payload[: u.tell()]
        return payload, records

    def _replay_mmap(self, f, path: str, state: int, crc: int):
        """The sidecar route: map the file read-only and take the record
        table from the sidecar. Returns (payload, records) or None for
        the decode walk.

        A finalized chunk with a finalized sidecar, both CRCs valid, is
        believed with no walk. Anything else is validated: the covered
        region must count, in the host codec, to exactly the table's
        records, and the tail past it (one partial append at most) is
        walked in Python. Any disagreement takes the decode walk; a CRC
        mismatch raises as it does there."""
        payload_off = f.tell()
        plen = os.fstat(f.fileno()).st_size - payload_off
        if plen <= 0:
            return None
        sc = _sidecar.read_sidecar(_sidecar.sidecar_path(path), plen)
        if sc is None:
            return None
        _sstate, ends, trusted = sc
        if not len(ends):
            return None
        try:
            mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):
            return None
        view = memoryview(mm)[payload_off:]
        try:
            if state == STATE_FINAL and self.checksum and crc:
                if _fp.ACTIVE:
                    _fp.fire("storage.crc_verify")
                if zlib.crc32(view) & 0xFFFFFFFF != crc:
                    raise ValueError("crc mismatch")
            else:
                trusted = False  # an open payload may be torn anywhere
            covered = int(ends[-1])
            records = int(len(ends))
            if trusted and covered == plen:
                self.replay_sidecar_trusted += 1
                end = covered
            else:
                from .. import native

                n = native.count_records(view[:covered])
                if n is None or n != records:
                    return None  # the table lies: the decode walk decides
                end = covered
                if covered < plen:
                    # the data flush outran the sidecar's: walk the tail
                    from ..codec.msgpack import Unpacker

                    u = Unpacker(bytes(view[covered:]))
                    for _ in u:
                        records += 1
                    end = covered + u.tell()
            return bytes(view[:end]), records
        finally:
            view.release()
            mm.close()

    def scan_backlog(self) -> List[Chunk]:
        """Recover the chunks a previous run left on disk. A file that
        does not read moves to ``dlq/<name>.corrupt``; an empty one is
        removed."""
        if _fp.ACTIVE:
            # a crash here dies mid-recovery: the next start must still
            # recover everything
            _fp.fire("storage.backlog_load")
        t0 = time.perf_counter()
        out: List[Chunk] = []
        for dirpath, _dirs, files in os.walk(self.streams_dir):
            for name in sorted(files):
                if not name.endswith(".flb"):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    chunk = self._read_chunk_file(path)
                except Exception as e:
                    log.warning("storage: corrupt chunk %s (%s) "
                                "quarantined to DLQ", path, e)
                    try:
                        os.rename(path, os.path.join(
                            self.dlq_dir, name + ".corrupt"))
                    except OSError:
                        log.exception("storage: cannot quarantine %s",
                                      path)
                    self._drop_sidecar(path)
                    continue
                if chunk.records == 0:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    self._drop_sidecar(path)
                    continue
                self._files[chunk.id] = (None, path)  # delivery deletes it
                out.append(chunk)
        self.replay_seconds += time.perf_counter() - t0
        return out

    def dlq_chunks(self) -> List[Chunk]:
        """The quarantined chunks (inspection, re-ingestion); an
        unreadable one is logged and skipped."""
        out = []
        for name in sorted(os.listdir(self.dlq_dir)):
            if name.endswith(".flb"):
                try:
                    out.append(self._read_chunk_file(
                        os.path.join(self.dlq_dir, name)))
                except Exception:
                    log.warning("unreadable DLQ chunk %s skipped", name,
                                exc_info=True)
        return out

    @staticmethod
    def _drop_sidecar(path: str) -> None:
        try:
            os.unlink(_sidecar.sidecar_path(path))
        except OSError:
            pass

    def close(self) -> None:
        for f, _ in list(self._files.values()):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        for writer in list(self._sidecars.values()):
            writer.close()
        self._sidecars.clear()
