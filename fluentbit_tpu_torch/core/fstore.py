"""fstore: a file-backed object store, the forward output's spool.

The port's own copy of ``fluentbit_tpu/core/fstore.py`` (reference
src/flb_fstore.c). Streams are directories; files are named objects with
byte content and a small JSON metadata sidecar. The port uses it for the
forward output's partition spool and the forward input's durable dedup
ledger (filesystem chunk storage is ``core.storage``).
"""

from __future__ import annotations

import json
import os
from typing import List


class FStoreFile:
    __slots__ = ("name", "path", "meta_path")

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self.meta_path = path + ".meta"

    def set_meta(self, meta: dict, durable: bool = False) -> None:
        """Write the JSON metadata sidecar. ``durable=True`` writes a
        temporary file, fsyncs it and renames it over the old one, so
        the sidecar is either the old version or the new, never torn."""
        if not durable:
            with open(self.meta_path, "w", encoding="utf-8") as f:
                json.dump(meta, f)
            return
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.meta_path)

    def meta(self) -> dict:
        try:
            with open(self.meta_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    @property
    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def delete(self) -> None:
        for p in (self.path, self.meta_path):
            try:
                os.unlink(p)
            except OSError:
                pass


class FStoreStream:
    def __init__(self, root: str, name: str):
        self.name = name
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir, exist_ok=True)

    def create(self, name: str) -> FStoreFile:
        f = FStoreFile(name, os.path.join(self.dir, name))
        open(f.path, "ab").close()  # a meta-only file must still exist
        return f

    def files(self) -> List[FStoreFile]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.endswith(".meta"):
                continue
            out.append(FStoreFile(name, os.path.join(self.dir, name)))
        return out


class FStore:
    """flb_fstore_create: a root of named streams."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def stream(self, name: str) -> FStoreStream:
        return FStoreStream(self.root, name)
