"""TLS: client and server SSL contexts from an instance's properties.

The port's own copy of ``fluentbit_tpu/core/tls.py`` (reference
src/tls/flb_tls.c + src/tls/openssl.c: ``tls``, ``tls.verify``,
``tls.ca_file``, ``tls.crt_file``, ``tls.key_file``, ``tls.vhost``).
Python's ``ssl`` module is the OpenSSL binding; asyncio runs the
handshake on the event loop. The plugins that dial or listen with TLS
(the forward input and output, the http input) declare the keys
(``core.config.TLS_CONFIG``); ``client_context(ins)`` /
``server_context(ins)`` return an ``ssl.SSLContext``, or None when
``tls`` is off.
"""

from __future__ import annotations

import asyncio
import ssl
from typing import Optional

from .. import failpoints as _fp
from .config import parse_bool


def _props(ins):
    get = ins.properties.get
    return {
        "on": parse_bool(get("tls", False)),
        "verify": parse_bool(get("tls.verify", True)),
        "ca_file": get("tls.ca_file"),
        "crt_file": get("tls.crt_file"),
        "key_file": get("tls.key_file"),
        "vhost": get("tls.vhost"),
    }


def client_context(ins) -> Optional[ssl.SSLContext]:
    """Upstream TLS (flb_tls_create for outputs)."""
    p = _props(ins)
    if not p["on"]:
        return None
    ctx = ssl.create_default_context(ssl.Purpose.SERVER_AUTH,
                                     cafile=p["ca_file"])
    if not p["verify"]:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if p["crt_file"]:
        ctx.load_cert_chain(p["crt_file"], p["key_file"])
    return ctx


def client_server_hostname(ins) -> Optional[str]:
    """SNI override (tls.vhost)."""
    return _props(ins)["vhost"]


async def open_connection(ins, host: str, port: int, timeout=None):
    """Client connect with the instance's TLS properties. Every resolved
    address (``core.upstream.resolve``, cached) is tried in order under
    one deadline for the whole dial; SNI and verification use the host
    name (or ``tls.vhost``), not the address dialed. When every address
    fails, the host's cache entry is dropped and the last error
    raises. The failpoint site ``upstream.connect`` fires first: its
    ``FailpointError`` is an ``OSError``, so each caller's dial-failure
    handling engages as it is."""
    from .upstream import invalidate_dns, resolve

    if _fp.ACTIVE:
        _fp.fire("upstream.connect")
    ctx = client_context(ins)
    try:
        addrs = await resolve(host, port)
    except OSError:
        addrs = [host]  # let the connect surface the resolution error
    sni = (client_server_hostname(ins) or host) if ctx else None
    last_err: Exception = OSError(f"no addresses for {host}")
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout
    for addr in addrs:
        try:
            if deadline is not None:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError()
                return await asyncio.wait_for(
                    asyncio.open_connection(addr, port, ssl=ctx,
                                            server_hostname=sni),
                    remaining)
            return await asyncio.open_connection(
                addr, port, ssl=ctx, server_hostname=sni)
        except (OSError, asyncio.TimeoutError) as e:
            last_err = e
    invalidate_dns(host, port)  # every cached address failed
    raise last_err


def server_context(ins) -> Optional[ssl.SSLContext]:
    """Downstream TLS (server inputs). ``tls on`` needs
    ``tls.crt_file``; a ``tls.ca_file`` makes client certificates
    required."""
    p = _props(ins)
    if not p["on"]:
        return None
    if not p["crt_file"]:
        raise ValueError(f"{ins.display_name}: tls on requires tls.crt_file")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(p["crt_file"], p["key_file"])
    if p["ca_file"]:
        ctx.load_verify_locations(p["ca_file"])
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
