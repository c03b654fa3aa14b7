"""msgpack codec (self-contained, no external dependency).

Implements the full msgpack spec (nil/bool/int/float/str/bin/array/map/ext),
including the Fluentd ``EventTime`` extension (ext type 0, 8 bytes:
uint32 seconds + uint32 nanoseconds) used for event timestamps.

Reference parity: lib/msgpack-c in the reference tree; EventTime semantics per
plugins/out_forward/forward.c (Fluentd forward protocol) and
src/flb_time.c (flb_time_append_to_msgpack).

The port's own copy of ``fluentbit_tpu/codec/msgpack.py`` (pure Python;
the reference package's native codec is not carried over).
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Iterator, List, Tuple

__all__ = [
    "packb",
    "unpackb",
    "Unpacker",
    "ExtType",
    "EventTime",
    "OutOfData",
]


class ExtType:
    """msgpack extension value: (code:int, data:bytes)."""

    __slots__ = ("code", "data")

    def __init__(self, code: int, data: bytes):
        self.code = code
        self.data = data

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ExtType)
            and self.code == other.code
            and self.data == other.data
        )

    def __hash__(self) -> int:
        return hash((self.code, self.data))

    def __repr__(self) -> str:  # pragma: no cover
        return f"ExtType(code={self.code}, data={self.data!r})"


class EventTime:
    """Fluentd EventTime: seconds + nanoseconds (msgpack ext type 0).

    Compared equal to other EventTime with the same (sec, nsec). Convertible
    to float (lossy) via float().
    """

    __slots__ = ("sec", "nsec")

    CODE = 0

    def __init__(self, sec: int, nsec: int = 0):
        self.sec = int(sec)
        self.nsec = int(nsec)

    @classmethod
    def from_float(cls, ts: float) -> "EventTime":
        sec = int(ts)
        nsec = int(round((ts - sec) * 1e9))
        if nsec >= 1_000_000_000:
            sec += 1
            nsec -= 1_000_000_000
        return cls(sec, nsec)

    def to_bytes(self) -> bytes:
        return struct.pack(">II", self.sec & 0xFFFFFFFF, self.nsec & 0xFFFFFFFF)

    @classmethod
    def from_bytes(cls, data: bytes) -> "EventTime":
        sec, nsec = struct.unpack(">II", data)
        return cls(sec, nsec)

    def __float__(self) -> float:
        return self.sec + self.nsec / 1e9

    def __eq__(self, other: object) -> bool:
        if isinstance(other, EventTime):
            return self.sec == other.sec and self.nsec == other.nsec
        if isinstance(other, (int, float)):
            return float(self) == float(other)
        return NotImplemented

    def __lt__(self, other: "EventTime") -> bool:
        return (self.sec, self.nsec) < (other.sec, other.nsec)

    def __hash__(self) -> int:
        return hash((self.sec, self.nsec))

    def __repr__(self) -> str:  # pragma: no cover
        return f"EventTime({self.sec}, {self.nsec})"


class OutOfData(Exception):
    """Raised when the buffer ends mid-object."""


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

_pack_into = struct.pack


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        if obj >= 0:
            if obj < 0x80:
                out.append(bytes((obj,)))
            elif obj <= 0xFF:
                out.append(b"\xcc" + bytes((obj,)))
            elif obj <= 0xFFFF:
                out.append(_pack_into(">BH", 0xCD, obj))
            elif obj <= 0xFFFFFFFF:
                out.append(_pack_into(">BI", 0xCE, obj))
            elif obj <= 0xFFFFFFFFFFFFFFFF:
                out.append(_pack_into(">BQ", 0xCF, obj))
            else:
                raise OverflowError("int too large for msgpack")
        else:
            if obj >= -32:
                out.append(_pack_into("b", obj))
            elif obj >= -128:
                out.append(_pack_into(">Bb", 0xD0, obj))
            elif obj >= -32768:
                out.append(_pack_into(">Bh", 0xD1, obj))
            elif obj >= -2147483648:
                out.append(_pack_into(">Bi", 0xD2, obj))
            elif obj >= -9223372036854775808:
                out.append(_pack_into(">Bq", 0xD3, obj))
            else:
                raise OverflowError("int too small for msgpack")
    elif t is float:
        out.append(_pack_into(">Bd", 0xCB, obj))
    elif t is str:
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes((0xA0 | n,)))
        elif n <= 0xFF:
            out.append(_pack_into(">BB", 0xD9, n))
        elif n <= 0xFFFF:
            out.append(_pack_into(">BH", 0xDA, n))
        else:
            out.append(_pack_into(">BI", 0xDB, n))
        out.append(b)
    elif t is bytes or t is bytearray or t is memoryview:
        b = bytes(obj)
        n = len(b)
        if n <= 0xFF:
            out.append(_pack_into(">BB", 0xC4, n))
        elif n <= 0xFFFF:
            out.append(_pack_into(">BH", 0xC5, n))
        else:
            out.append(_pack_into(">BI", 0xC6, n))
        out.append(b)
    elif t is list or t is tuple:
        n = len(obj)
        if n < 16:
            out.append(bytes((0x90 | n,)))
        elif n <= 0xFFFF:
            out.append(_pack_into(">BH", 0xDC, n))
        else:
            out.append(_pack_into(">BI", 0xDD, n))
        for item in obj:
            _pack(item, out)
    elif t is dict:
        n = len(obj)
        if n < 16:
            out.append(bytes((0x80 | n,)))
        elif n <= 0xFFFF:
            out.append(_pack_into(">BH", 0xDE, n))
        else:
            out.append(_pack_into(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is EventTime:
        # fixext8, type 0
        out.append(b"\xd7\x00" + obj.to_bytes())
    elif t is ExtType:
        data = obj.data
        n = len(data)
        code = obj.code & 0xFF
        if n == 1:
            out.append(bytes((0xD4, code)))
        elif n == 2:
            out.append(bytes((0xD5, code)))
        elif n == 4:
            out.append(bytes((0xD6, code)))
        elif n == 8:
            out.append(bytes((0xD7, code)))
        elif n == 16:
            out.append(bytes((0xD8, code)))
        elif n <= 0xFF:
            out.append(_pack_into(">BBB", 0xC7, n, code))
        elif n <= 0xFFFF:
            out.append(_pack_into(">BHB", 0xC8, n, code))
        else:
            out.append(_pack_into(">BIB", 0xC9, n, code))
        out.append(data)
    elif isinstance(obj, (int, float, str, bytes, list, tuple, dict)):
        # subclasses (e.g. enum.IntEnum, numpy scalars via __index__)
        if isinstance(obj, bool):
            out.append(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, int):
            _pack(int(obj), out)
        elif isinstance(obj, float):
            _pack(float(obj), out)
        elif isinstance(obj, str):
            _pack(str(obj), out)
        elif isinstance(obj, bytes):
            _pack(bytes(obj), out)
        elif isinstance(obj, (list, tuple)):
            _pack(list(obj), out)
        else:
            _pack(dict(obj), out)
    else:
        # numpy integer/float scalars without being subclasses
        if hasattr(obj, "item"):
            _pack(obj.item(), out)
            return
        raise TypeError(f"cannot pack object of type {t!r}")


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` to msgpack bytes."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_F32 = struct.Struct(">f")
_F64 = struct.Struct(">d")


def _default_ext_hook(code: int, data: bytes) -> Any:
    if code == EventTime.CODE and len(data) == 8:
        return EventTime.from_bytes(data)
    return ExtType(code, data)


class Unpacker:
    """Streaming unpacker over a bytes-like buffer.

    Usage::

        u = Unpacker(buf)
        for obj in u: ...

    ``tell()`` reports the byte offset of the next object, which the chunk
    layer uses to slice raw per-record msgpack regions out of a chunk.
    """

    def __init__(self, buf: bytes = b"", ext_hook: Callable[[int, bytes], Any] = _default_ext_hook):
        self._buf = memoryview(bytes(buf)) if not isinstance(buf, (bytes, memoryview)) else memoryview(buf)
        self._pos = 0
        self._ext_hook = ext_hook

    def feed(self, data: bytes) -> None:
        remaining = bytes(self._buf[self._pos:]) + bytes(data)
        self._buf = memoryview(remaining)
        self._pos = 0

    def tell(self) -> int:
        return self._pos

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._pos >= len(self._buf):
            raise StopIteration
        start = self._pos
        try:
            return self._unpack_one()
        except OutOfData:
            self._pos = start
            raise StopIteration

    def unpack(self) -> Any:
        """Unpack a single object; raises OutOfData if incomplete."""
        return self._unpack_one()

    # -- internals --

    def _need(self, n: int) -> memoryview:
        if self._pos + n > len(self._buf):
            raise OutOfData()
        mv = self._buf[self._pos : self._pos + n]
        self._pos += n
        return mv

    def _unpack_one(self) -> Any:
        b = self._need(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._unpack_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._unpack_array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._need(b & 0x1F), "utf-8", "replace")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xC4:
            return bytes(self._need(self._need(1)[0]))
        if b == 0xC5:
            return bytes(self._need(_U16.unpack(self._need(2))[0]))
        if b == 0xC6:
            return bytes(self._need(_U32.unpack(self._need(4))[0]))
        if b == 0xC7:
            n = self._need(1)[0]
            code = _I8.unpack(self._need(1))[0]
            return self._ext_hook(code, bytes(self._need(n)))
        if b == 0xC8:
            n = _U16.unpack(self._need(2))[0]
            code = _I8.unpack(self._need(1))[0]
            return self._ext_hook(code, bytes(self._need(n)))
        if b == 0xC9:
            n = _U32.unpack(self._need(4))[0]
            code = _I8.unpack(self._need(1))[0]
            return self._ext_hook(code, bytes(self._need(n)))
        if b == 0xCA:
            return _F32.unpack(self._need(4))[0]
        if b == 0xCB:
            return _F64.unpack(self._need(8))[0]
        if b == 0xCC:
            return self._need(1)[0]
        if b == 0xCD:
            return _U16.unpack(self._need(2))[0]
        if b == 0xCE:
            return _U32.unpack(self._need(4))[0]
        if b == 0xCF:
            return _U64.unpack(self._need(8))[0]
        if b == 0xD0:
            return _I8.unpack(self._need(1))[0]
        if b == 0xD1:
            return _I16.unpack(self._need(2))[0]
        if b == 0xD2:
            return _I32.unpack(self._need(4))[0]
        if b == 0xD3:
            return _I64.unpack(self._need(8))[0]
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            code = _I8.unpack(self._need(1))[0]
            return self._ext_hook(code, bytes(self._need(n)))
        if b == 0xD9:
            return str(self._need(self._need(1)[0]), "utf-8", "replace")
        if b == 0xDA:
            return str(self._need(_U16.unpack(self._need(2))[0]), "utf-8", "replace")
        if b == 0xDB:
            return str(self._need(_U32.unpack(self._need(4))[0]), "utf-8", "replace")
        if b == 0xDC:
            return self._unpack_array(_U16.unpack(self._need(2))[0])
        if b == 0xDD:
            return self._unpack_array(_U32.unpack(self._need(4))[0])
        if b == 0xDE:
            return self._unpack_map(_U16.unpack(self._need(2))[0])
        if b == 0xDF:
            return self._unpack_map(_U32.unpack(self._need(4))[0])
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def _unpack_array(self, n: int) -> list:
        return [self._unpack_one() for _ in range(n)]

    def _unpack_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self._unpack_one()
            if isinstance(k, (dict, list)):
                k = repr(k)  # unhashable keys: degrade gracefully
            out[k] = self._unpack_one()
        return out


def unpackb(buf: bytes) -> Any:
    """Deserialize a single msgpack object from ``buf``."""
    u = Unpacker(buf)
    obj = u.unpack()
    return obj


def unpack_all(buf: bytes) -> List[Any]:
    """Deserialize all concatenated msgpack objects in ``buf``."""
    return list(Unpacker(buf))
