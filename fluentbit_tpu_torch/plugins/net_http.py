"""HTTP input — HTTP/1.1 JSON server on the engine's loop.

The port's own copy of the server half of ``fluentbit_tpu/plugins/net_http.py``
(reference: plugins/in_http). A POST body is a JSON map, an array of maps
or NDJSON; the URI path becomes the tag (``/`` keeps the input's tag),
or ``tag_key`` names a record field that does. Keep-alive connections,
``Content-Length`` or chunked bodies, and Content-Encoding identity,
gzip or deflate; any other encoding answers 400. ``tls on`` (with
``tls.crt_file`` and ``tls.key_file``) wraps the listener
(``core.tls.server_context``). HTTP/2, zstd and snappy wait for a later
slice.
"""

from __future__ import annotations

import asyncio
import gzip
import json
import logging
import zlib
from typing import Dict, List, Optional, Tuple

from ..codec.events import encode_event, now_event_time
from ..core.config import TLS_CONFIG, ConfigMapEntry
from ..core.plugin import InputPlugin, registry
from ..core.tls import server_context
from ..ops.device import DEVICE_ERRORS

log = logging.getLogger("flb.http")


async def read_http_request(
        reader) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Parse one HTTP/1.1 request; returns (method, uri, headers, body),
    or None at the end of the connection or on a malformed request line."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, uri, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        if b":" in h:
            k, v = h.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = b""
    n = int(headers.get("content-length", 0) or 0)
    if n > 0:
        body = await reader.readexactly(n)
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size = int((await reader.readline()).strip() or b"0", 16)
            if size == 0:
                await reader.readline()
                break
            body += await reader.readexactly(size)
            await reader.readline()
    return method, uri, headers, body


def http_response(status: int, body: bytes = b"",
                  content_type: str = "text/plain") -> bytes:
    reason = {200: "OK", 201: "Created", 204: "No Content",
              400: "Bad Request", 404: "Not Found",
              500: "Internal Server Error"}.get(status, "OK")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Length: {len(body)}",
            f"Content-Type: {content_type}"]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def _parse_json_bodies(body: bytes) -> Optional[List[dict]]:
    """in_http body handling: map | array of maps | NDJSON; None when
    the body is none of these."""
    text = body.decode("utf-8", "replace").strip()
    if not text:
        return []
    try:
        obj = json.loads(text)
        if isinstance(obj, dict):
            return [obj]
        if isinstance(obj, list) and all(isinstance(o, dict) for o in obj):
            return obj
        return None
    except ValueError:
        pass
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            o = json.loads(line)
        except ValueError:
            return None
        if not isinstance(o, dict):
            return None
        out.append(o)
    return out


def _decode_content(headers: Dict[str, str], body: bytes) -> Optional[bytes]:
    """The request body after its Content-Encoding, or None when the
    encoding is unsupported or the bytes do not decode."""
    algo = headers.get("content-encoding", "").lower()
    if not algo or not body or algo == "identity":
        return body
    try:
        if algo == "gzip":
            return gzip.decompress(body)
        if algo == "deflate":
            return zlib.decompress(body)
    except (OSError, EOFError, zlib.error):
        return None  # undecodable bytes answer 400
    return None  # an encoding passed through would mint garbage records


class HttpServerInputBase(InputPlugin):
    """Server skeleton for server-type inputs. Subclasses implement
    ``handle_request(engine, method, path, headers, body) -> (status,
    resp_bytes)``; the base runs the accept loop, keep-alive
    (``Connection: close`` honoured), HEAD body suppression and error
    isolation (a raising handler answers 500)."""

    server_task_needed = True
    content_type = "application/json"

    def init(self, instance, engine) -> None:
        self.bound_port: Optional[int] = None
        # built here, so a bad certificate raises from start()
        self._ssl = server_context(instance)
        self._writers: set = set()
        # set once the listener closes: a request still buffered on a
        # connection is not taken (its answer could not be written)
        self._closed = False

    def handle_request(self, engine, method, path, headers,
                       body):  # pragma: no cover
        raise NotImplementedError

    async def _handle(self, engine, reader, writer) -> None:
        self._writers.add(writer)
        try:
            while True:
                req = await read_http_request(reader)
                if req is None or self._closed:
                    break
                method, uri, headers, body = req
                decoded = _decode_content(headers, body)
                if decoded is None:
                    status, resp = 400, b"bad content encoding\n"
                else:
                    try:
                        status, resp = self.handle_request(
                            engine, method, uri.split("?")[0], headers,
                            decoded)
                    except DEVICE_ERRORS:
                        raise  # counted by the engine; no answer
                    except Exception:
                        log.exception("%s request handler failed", self.name)
                        status, resp = 500, b"{}"
                if method == "HEAD":
                    resp = b""  # RFC 9110: HEAD carries no body
                writer.write(http_response(status, resp, self.content_type))
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def start_server(self, engine):
        """Bind (``port`` 0 picks a free port, read back as
        ``bound_port``) and return the coroutine that keeps serving
        until it is cancelled, then closes the listener and every open
        connection."""
        server = await asyncio.start_server(
            lambda r, w: self._handle(engine, r, w), self.listen, self.port,
            ssl=self._ssl)
        self.bound_port = server.sockets[0].getsockname()[1]

        async def serve() -> None:
            try:
                await asyncio.Event().wait()
            finally:
                self._closed = True
                server.close()
                for w in list(self._writers):
                    w.close()

        return serve()


@registry.register
class HttpInput(HttpServerInputBase):
    name = "http"
    description = "HTTP server input (JSON/NDJSON bodies)"
    content_type = "text/plain"
    config_map = [
        ConfigMapEntry("listen", "str", default="0.0.0.0"),
        ConfigMapEntry("port", "int", default=9880),
        ConfigMapEntry("tag_key", "str"),
        ConfigMapEntry("successful_response_code", "int", default=201),
    ] + TLS_CONFIG

    def handle_request(self, engine, method, path, headers, body):
        if method != "POST":
            return 400, b"POST only\n"
        bodies = _parse_json_bodies(body)
        if bodies is None:
            return 400, b"bad body\n"
        uri_tag = path.lstrip("/").replace("/", ".") or self.instance.tag
        # tag_key resolves per record: one append per tag group
        groups: Dict[str, bytearray] = {}
        counts: Dict[str, int] = {}
        for b in bodies:
            tag = uri_tag
            if self.tag_key and isinstance(b.get(self.tag_key), str):
                tag = b[self.tag_key]
            groups.setdefault(tag, bytearray())
            groups[tag] += encode_event(b, now_event_time())
            counts[tag] = counts.get(tag, 0) + 1
        for tag, buf in groups.items():
            engine.input_log_append(self.instance, tag, bytes(buf),
                                    counts[tag])
        return (self.successful_response_code or 201), b""
