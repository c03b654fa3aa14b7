"""in_forward — the Fluentd Forward protocol server on the engine's loop.

The port's own copy of ``ForwardInput`` from
``fluentbit_tpu/plugins/net_forward.py`` (reference: plugins/in_forward,
fw_prot.c). Wire formats accepted:

- Message:        ``[tag, time, record, option?]``
- Forward:        ``[tag, [[time, record], ...], option?]``
- PackedForward:  ``[tag, bin(msgpack stream of [time, record]), option?]``
  (CompressedPackedForward when ``option.compressed == "gzip"``; a body
  of several gzip members decodes whole)

When ``option.chunk`` is present the server answers ``{"ack": chunk}``,
written only after the records were absorbed. ``shared_key`` runs the
HELO/PING/PONG handshake first. ``tag_prefix`` prefixes every tag.
``dedup`` (on by default) keeps an in-memory ledger of absorbed chunk
ids (``core.relay.DedupLedger``): a chunk resent with the same id inside
``dedup_ttl`` is acked without being absorbed again.

Each message's records go through ``engine.input_log_append``
synchronously on the engine's loop: the filter chain, its kernel
launches and readbacks run inside it, and the ack follows. The port has
no qos plane and no input backpressure, so an append always absorbs: a
wire-stamped tenant (``option.tenant`` / ``priority``) is validated as
the reference validates it and admitted, as the reference admits a
tenant without a bucket; the stamp is not carried onto the chunk (the
port's chunks have no stamps). TLS on the listener and a
``defer_ack_window`` other than its default raise; the forward output
waits for a later slice.
"""

from __future__ import annotations

import asyncio
import gzip
import hashlib
import logging
import os
from typing import Optional

from ..codec.events import encode_event
from ..codec.msgpack import Unpacker, packb
from ..core.config import ConfigMapEntry
from ..core.plugin import InputPlugin, registry
from ..core.relay import DedupLedger
from ..core.upstream import close_quietly

log = logging.getLogger("flb.forward")

#: wire-stamp hygiene: the tenant name crosses a trust boundary, so it
#: is bounded before anything keys on it
_TENANT_MAX_LEN = 128
_PRIORITY_MAX = 7
_DEFER_ACK_WINDOW = "5"


def _entries_to_events(entries) -> tuple:
    """Forward entries [[time, record], ...] → (encoded V2 buffer, n);
    entries that are not a [time, map] pair are skipped."""
    out = bytearray()
    n = 0
    for entry in entries:
        if not isinstance(entry, (list, tuple)) or len(entry) < 2:
            continue
        ts, record = entry[0], entry[1]
        if not isinstance(record, dict):
            continue
        out += encode_event(record, ts)
        n += 1
    return bytes(out), n


def _wire_stamp(option) -> tuple:
    """(tenant, priority) from a forward option map, validated: an
    oversized or wrongly typed value degrades to unstamped."""
    if not isinstance(option, dict):
        return None, None
    tenant = option.get("tenant")
    if not isinstance(tenant, str) or not tenant \
            or len(tenant) > _TENANT_MAX_LEN:
        tenant = None
    priority = option.get("priority")
    if isinstance(priority, bool) or not isinstance(priority, int):
        priority = None
    else:
        priority = min(max(priority, 0), _PRIORITY_MAX)
    return tenant, priority


@registry.register
class ForwardInput(InputPlugin):
    name = "forward"
    description = "Fluentd Forward protocol server"
    server_task_needed = True
    config_map = [
        ConfigMapEntry("listen", "str", default="0.0.0.0"),
        ConfigMapEntry("port", "int", default=24224),
        ConfigMapEntry("shared_key", "str"),
        ConfigMapEntry("self_hostname", "str", default="fluentbit-tpu"),
        ConfigMapEntry("tag_prefix", "str"),
        ConfigMapEntry("dedup", "bool", default=True,
                       desc="ack a redelivered chunk id without absorbing "
                            "it again (in-memory ledger)"),
        ConfigMapEntry("dedup_ttl", "time", default="300",
                       desc="how long an absorbed chunk id stays in the "
                            "ledger"),
        ConfigMapEntry("defer_ack_window", "time",
                       default=_DEFER_ACK_WINDOW,
                       desc="not ported: only the default is accepted"),
    ]

    def init(self, instance, engine) -> None:
        from ..core.config import parse_time

        if self.defer_ack_window != parse_time(_DEFER_ACK_WINDOW):
            raise ValueError("forward: defer_ack_window is not ported (the "
                             "port has no input backpressure)")
        self.bound_port: Optional[int] = None
        self._writers: set = set()
        self._ledger: Optional[DedupLedger] = None
        if self.dedup:
            self._ledger = DedupLedger(None, ttl=self.dedup_ttl)
        self.n_absorbed = 0
        self.n_deferred_acks = 0
        self.n_withheld_acks = 0
        self.n_shed_remote = 0
        m = engine.metrics
        self._m_dedup = m.counter(
            "fluentbit", "forward", "dedup_hits_total",
            "Redelivered chunk ids absorbed zero times (acked from "
            "the dedup ledger)", ("instance",))
        self._m_absorbed = m.counter(
            "fluentbit", "forward", "absorbed_chunks_total",
            "Forward chunks absorbed into engine state", ("instance",))
        self._m_deferred = m.counter(
            "fluentbit", "forward", "deferred_acks_total",
            "Acks delayed by quota/buffer backpressure", ("instance",))
        self._m_withheld = m.counter(
            "fluentbit", "forward", "withheld_acks_total",
            "Acks withheld after the defer window (peer retries)",
            ("instance",))

    async def start_server(self, engine):
        """Bind (``port`` 0 picks a free port, read back as
        ``bound_port``) and return the coroutine that serves until it is
        cancelled, then closes the listener and every open connection."""
        async def handle(reader, writer):
            self._writers.add(writer)
            try:
                await self._handle_conn(reader, writer, engine)
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            except Exception:
                log.exception("in_forward connection failed")
            finally:
                self._writers.discard(writer)
                close_quietly(writer)

        server = await asyncio.start_server(handle, self.listen, self.port)
        self.bound_port = server.sockets[0].getsockname()[1]

        async def serve() -> None:
            try:
                await asyncio.Event().wait()
            finally:
                server.close()
                for w in list(self._writers):
                    close_quietly(w)

        return serve()

    async def _handle_conn(self, reader, writer, engine) -> None:
        nonce = b""
        if self.shared_key:
            # HELO/PING/PONG handshake (forward.c:259-340 client side)
            nonce = os.urandom(16)
            writer.write(packb(["HELO", {"nonce": nonce, "auth": b"",
                                         "keepalive": True}]))
            await writer.drain()
        u = Unpacker()
        authed = not self.shared_key
        while True:
            data = await reader.read(65536)
            if not data:
                return
            u.feed(data)
            for msg in u:
                if not isinstance(msg, (list, tuple)) or not msg:
                    continue
                if not authed:
                    authed = self._check_ping(msg, nonce, writer)
                    if not authed:
                        return
                    await writer.drain()
                    continue
                await self._dispatch(msg, writer, engine)

    def _check_ping(self, msg, nonce: bytes, writer) -> bool:
        if msg[0] != "PING" or len(msg) < 6:
            return False
        hostname, salt, digest = msg[1], msg[2], msg[3]
        salt = salt if isinstance(salt, bytes) else str(salt).encode()
        want = hashlib.sha512(
            salt + str(hostname).encode() + nonce + self.shared_key.encode()
        ).hexdigest()
        ok = digest == want
        shared_key_digest = hashlib.sha512(
            salt + self.self_hostname.encode() + nonce
            + self.shared_key.encode()
        ).hexdigest()
        writer.write(packb(["PONG", ok, "" if ok else "shared_key mismatch",
                            self.self_hostname, shared_key_digest]))
        return ok

    async def _dispatch(self, msg, writer, engine) -> None:
        tag = msg[0]
        if not isinstance(tag, str):
            return
        if self.tag_prefix:
            tag = f"{self.tag_prefix}.{tag}"
        option = None
        if isinstance(msg[1], (bytes, memoryview)):
            # PackedForward / CompressedPackedForward
            option = msg[2] if len(msg) > 2 and isinstance(msg[2], dict) \
                else None
            blob = bytes(msg[1])
            if option and option.get("compressed") == "gzip":
                blob = gzip.decompress(blob)
            buf, n = _entries_to_events(list(Unpacker(blob)))
        elif isinstance(msg[1], (list, tuple)):
            # Forward mode
            option = msg[2] if len(msg) > 2 and isinstance(msg[2], dict) \
                else None
            buf, n = _entries_to_events(msg[1])
        else:
            # Message mode [tag, time, record, option?]
            if len(msg) < 3 or not isinstance(msg[2], dict):
                return
            option = msg[3] if len(msg) > 3 and isinstance(msg[3], dict) \
                else None
            buf, n = _entries_to_events([[msg[1], msg[2]]])
        ack_ref = option.get("chunk") if option else None
        cid = self._chunk_key(ack_ref)
        if n:
            if cid is not None and self._ledger is not None \
                    and self._ledger.seen(cid):
                # a redelivery inside the retry window: acked, absorbed
                # zero times
                self._m_dedup.inc(1, (self.instance.display_name,))
            else:
                # a wire-stamped tenant is admitted: with no qos plane
                # it has no bucket (the stamp is not carried further)
                self._absorb(engine, tag, buf, n, cid)
        if ack_ref is not None:
            writer.write(packb({"ack": ack_ref}))
            await writer.drain()

    @staticmethod
    def _chunk_key(ack_ref) -> Optional[str]:
        """Ledger key for a wire ``chunk`` option (str or bytes)."""
        if ack_ref is None:
            return None
        if isinstance(ack_ref, (bytes, memoryview)):
            return bytes(ack_ref).decode("latin-1")
        return str(ack_ref)

    def _absorb(self, engine, tag: str, buf: bytes, n: int,
                cid: Optional[str]) -> None:
        """Absorb one decoded chunk into engine state, then record its
        id before the ack leaves. ``input_log_append`` raises rather
        than defer in the port, so the reference's defer loop is one
        append, and a raise closes the connection without an ack."""
        ins = self.instance
        engine.input_log_append(ins, tag, buf, n)
        if cid is not None and self._ledger is not None:
            self._ledger.record(cid)
        self.n_absorbed += 1
        self._m_absorbed.inc(1, (ins.display_name,))

    def health_block(self) -> dict:
        out = {
            "role": "server",
            "absorbed": self.n_absorbed,
            "deferred_acks": self.n_deferred_acks,
            "withheld_acks": self.n_withheld_acks,
            "shed_remote": self.n_shed_remote,
        }
        if self._ledger is not None:
            out["dedup_hits"] = self._ledger.dedup_hits
            out["dedup_entries"] = self._ledger.size()
        return out
