"""Shared helpers.

The port's own copy of ``sync_http_request`` from
``fluentbit_tpu/utils/__init__.py`` (reference flb_http_client with the
stream in synchronous mode), which filter_kubernetes' ``kube_url``
fetch uses. The reference's other helpers wait for the plugins that
need them.
"""

from __future__ import annotations

from typing import Optional


def sync_http_request(host: str, port: int, method: str, path: str,
                      headers=None, body: bytes = b"", tls: bool = False,
                      tls_verify: bool = True, timeout: float = 10.0,
                      max_bytes: int = 64 * 1024 * 1024,
                      tls_ca_file: Optional[str] = None):
    """Blocking HTTP/1.1 request over stdlib ``socket`` / ``ssl`` →
    ``(status, headers_dict, body)``, or None on a socket, TLS or parse
    failure. ``tls_ca_file`` pins a private CA (the kubernetes
    service-account ``ca.crt``); a chunked body is reassembled; a
    response past ``max_bytes`` is abandoned, not truncated."""
    import socket as _socket
    import ssl as _ssl

    try:
        s = _socket.create_connection((host, port), timeout=timeout)
        if tls:
            ctx = _ssl.create_default_context(cafile=tls_ca_file)
            if not tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = _ssl.CERT_NONE
            s = ctx.wrap_socket(s, server_hostname=host)
        req = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
               "Connection: close", f"Content-Length: {len(body)}"]
        for k, v in (headers or {}).items():
            req.append(f"{k}: {v}")
        s.sendall(("\r\n".join(req) + "\r\n\r\n").encode() + body)
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
            if len(data) > max_bytes:
                s.close()
                return None
        s.close()
        head, _, resp = data.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        status = int(lines[0].split(b" ", 2)[1])
        hdrs = {}
        for line in lines[1:]:
            k, _, v = line.partition(b":")
            hdrs[k.strip().decode("latin-1").lower()] = \
                v.strip().decode("latin-1")
        if hdrs.get("transfer-encoding", "").lower() == "chunked":
            out, rest = b"", resp
            while rest:
                size_line, _, rest = rest.partition(b"\r\n")
                size = int(size_line.split(b";")[0], 16)
                if size == 0:
                    break
                out += rest[:size]
                rest = rest[size + 2:]
            resp = out
        return status, hdrs, resp
    except (OSError, ValueError, IndexError, _ssl.SSLError):
        return None
