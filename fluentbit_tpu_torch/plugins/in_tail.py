"""in_tail — follow files, emit lines as log records.

The port's own copy of ``fluentbit_tpu/plugins/in_tail.py`` in stat mode.
Reference: plugins/in_tail (tail.c, tail_file.c line processing,
tail_scan_glob.c path scanning, rotation via inode tracking in
tail_fs_stat.c).

- ``path``: comma-separated globs, less the ``exclude_path`` globs,
  re-scanned every ``refresh_interval``
- every file is read on every collector tick (stat polling): per-file
  offset + inode tracking; rotation = inode change under the same name
  (the old fd drained to EOF first), truncation = size < offset
- records are ``{key: line}`` (``path_key`` adds the file's path); one
  ``input_log_append`` per 64 KiB read
- ``tag``: a ``*`` in the tag expands to the file path with separators
  mapped to dots (the reference's tag expansion)
- ``skip_long_lines``: lines above ``buffer_max_size`` are dropped with
  a warning instead of blocking the file
- ``parser``: each line goes through the named parser (engine
  ``parsers``); a parsed line becomes the parsed fields, stamped with
  the parsed time when it is non-zero, and a line the parser refuses
  stays ``{key: line}``

``inotify_watcher`` is accepted: stat polling serves, as the reference
falls back to it where inotify is missing, with the same records in the
same order. ``db``, ``multiline.parser``, ``unicode.encoding`` and
``generic.encoding`` are not ported yet; setting one raises ValueError.
"""

from __future__ import annotations

import glob as _glob
import logging
import os
from typing import Dict, List

from ..codec.events import encode_event, now_event_time
from ..core.config import ConfigMapEntry, parse_size
from ..core.plugin import InputPlugin, registry

log = logging.getLogger("flb.tail")

#: properties of the reference's tail that this port does not run yet
_NOT_PORTED = ("db", "multiline.parser", "unicode.encoding",
               "generic.encoding")


class _TailFile:
    __slots__ = ("path", "fd", "inode", "offset", "pending", "skipping")

    def __init__(self, path: str, inode: int, offset: int = 0):
        self.path = path
        self.fd = None
        self.inode = inode
        self.offset = offset
        self.pending = b""
        self.skipping = False  # discarding an oversized line's remainder


@registry.register
class TailInput(InputPlugin):
    name = "tail"
    description = "follow files and emit appended lines"
    collect_interval = 0.25
    config_map = [
        ConfigMapEntry("path", "clist"),
        ConfigMapEntry("inotify_watcher", "bool", default=True,
                       desc="accepted; stat polling serves"),
        ConfigMapEntry("exclude_path", "clist"),
        ConfigMapEntry("path_key", "str"),
        ConfigMapEntry("key", "str", default="log"),
        ConfigMapEntry("refresh_interval", "time", default="60"),
        ConfigMapEntry("read_from_head", "bool", default=False),
        ConfigMapEntry("buffer_max_size", "str", default="32k"),
        ConfigMapEntry("skip_long_lines", "bool", default=False),
        ConfigMapEntry("rotate_wait", "time", default="5"),
        ConfigMapEntry("parser", "str"),
    ] + [ConfigMapEntry(name, "str", desc="not ported: raises")
         for name in _NOT_PORTED]

    def init(self, instance, engine) -> None:
        for name in _NOT_PORTED:
            if getattr(self, name.replace(".", "_")):
                raise ValueError(f"tail: property {name!r} is not "
                                 f"supported by this port yet")
        if not self.path:
            raise ValueError("tail: path is required")
        self._files: Dict[str, _TailFile] = {}
        self._since_scan = float("inf")  # force a scan on first collect
        self._max_line = parse_size(self.buffer_max_size)
        self._parser = None
        if self.parser:
            self._parser = engine.parsers.get(self.parser)
            if self._parser is None:
                raise ValueError(f"tail: unknown parser {self.parser!r}")

    def exit(self) -> None:
        for tf in self._files.values():
            if tf.fd is not None:
                try:
                    tf.fd.close()
                except OSError:
                    pass

    # -- scanning --

    def _scan(self, initial: bool = False) -> None:
        excluded = set()
        for pat in self.exclude_path or []:
            excluded.update(_glob.glob(pat))
        for pat in self.path:
            for path in sorted(_glob.glob(pat)):
                if path in excluded or path in self._files:
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                # read_from_head governs files present at STARTUP;
                # files appearing later are always read from 0 (the
                # reference's tail_scan semantics)
                offset = 0 if (self.read_from_head or not initial) \
                    else st.st_size
                self._files[path] = _TailFile(path, st.st_ino, offset)

    # -- reading --

    def collect(self, engine) -> None:
        initial = self._since_scan == float("inf")
        self._since_scan += self.collect_interval
        if self._since_scan >= self.refresh_interval:
            self._scan(initial=initial)
            self._since_scan = 0.0
        for tf in list(self._files.values()):
            self._read_file(tf, engine)

    def _read_file(self, tf: _TailFile, engine) -> None:
        try:
            st = os.stat(tf.path)
        except OSError:
            st = None  # deleted; drain the open fd below then drop
        if tf.fd is None:
            try:
                tf.fd = open(tf.path, "rb")
                tf.fd.seek(tf.offset)
            except OSError:
                self._files.pop(tf.path, None)
                return
        # truncation: file shrank under the same inode
        if st is not None and st.st_ino == tf.inode and st.st_size < tf.offset:
            tf.fd.seek(0)
            tf.offset = 0
            tf.pending = b""
            tf.skipping = False
        self._drain_fd(tf, engine)
        # rotation: name now points at a different inode — finish the old
        # file (drained above), then follow the new one from offset 0
        if st is not None and st.st_ino != tf.inode:
            try:
                tf.fd.close()
            except OSError:
                pass
            tf.fd = None
            tf.inode = st.st_ino
            tf.offset = 0
            tf.pending = b""
            tf.skipping = False
            self._drain_fd(tf, engine, reopen=True)
        elif st is None:
            try:
                tf.fd.close()
            except OSError:
                pass
            self._files.pop(tf.path, None)

    def _drain_fd(self, tf: _TailFile, engine, reopen: bool = False) -> None:
        if reopen:
            try:
                tf.fd = open(tf.path, "rb")
            except OSError:
                return
        while True:
            chunk = tf.fd.read(65536)
            if not chunk:
                break
            tf.offset += len(chunk)
            if tf.skipping:
                # discard up to (and including) the oversized line's
                # terminating newline so its tail never becomes a record
                nl = chunk.find(b"\n")
                if nl < 0:
                    continue
                chunk = chunk[nl + 1:]
                tf.skipping = False
            data = tf.pending + chunk
            lines = data.split(b"\n")
            tf.pending = lines.pop()
            if len(tf.pending) > self._max_line and self.skip_long_lines:
                log.warning("tail: dropping long line in %s", tf.path)
                tf.pending = b""
                tf.skipping = True
            # else: keep buffering (the reference blocks the file; the
            # pending buffer grows)
            if lines:
                self._emit_lines(tf, lines, engine)

    def _emit_lines(self, tf: _TailFile, lines: List[bytes], engine) -> None:
        decoded = [raw.rstrip(b"\r").decode("utf-8", "replace")
                   for raw in lines]
        self._emit_texts(tf.path, self._tag_for(tf.path), decoded, engine)

    def _emit_texts(self, path: str, tag: str, texts: List[str],
                    engine) -> None:
        out = bytearray()
        n = 0
        for line in texts:
            if not line:
                continue
            if len(line) > self._max_line and self.skip_long_lines:
                log.warning("tail: dropping long line in %s", path)
                continue
            body = None
            ts = None
            if self._parser is not None:
                got = self._parser.do(line)
                if got is not None:
                    body, ts = got
            if body is None:
                body = {self.key or "log": line}
            if self.path_key:
                body[self.path_key] = path
            out += encode_event(
                body, ts if ts not in (None, 0) else now_event_time())
            n += 1
        if n:
            engine.input_log_append(self.instance, tag, bytes(out), n)

    def _tag_for(self, path: str) -> str:
        tag = self.instance.tag or "tail.0"
        if "*" in tag:
            expanded = path.lstrip("/").replace("/", ".")
            tag = tag.replace("*", expanded)
        return tag
