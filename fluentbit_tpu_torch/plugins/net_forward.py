"""The Fluentd Forward protocol: in_forward's server and out_forward's
client on the engine's loop.

The port's own copy of ``ForwardInput`` and ``ForwardOutput`` from
``fluentbit_tpu/plugins/net_forward.py`` (reference: plugins/in_forward,
fw_prot.c; plugins/out_forward, forward.c). Wire formats the server
accepts:

- Message:        ``[tag, time, record, option?]``
- Forward:        ``[tag, [[time, record], ...], option?]``
- PackedForward:  ``[tag, bin(msgpack stream of [time, record]), option?]``
  (CompressedPackedForward when ``option.compressed == "gzip"``; a body
  of several gzip members decodes whole)

When ``option.chunk`` is present the server answers ``{"ack": chunk}``,
written only after the records were absorbed. ``shared_key`` runs the
HELO/PING/PONG handshake first. ``tag_prefix`` prefixes every tag.
``dedup`` (on by default) keeps a ledger of absorbed chunk ids
(``core.relay.DedupLedger``, durable under the service's
``storage.path``): a chunk resent with the same id inside ``dedup_ttl``
is acked without being absorbed again, after a restart too when the
ledger is durable. ``tls on`` (with
``tls.crt_file``, ``tls.key_file``, and ``tls.ca_file`` to require client
certificates) wraps the listener (``core.tls.server_context``).

Each message's records go through ``engine.input_log_append``
synchronously on the engine's loop: the filter chain, its kernel
launches and readbacks run inside it, and the ack follows, after the
ledger recorded the chunk. An append that backpressure refuses (-1: the
input over its ``mem_buf_limit``) delays the ack and is retried every
50 ms for up to ``defer_ack_window`` seconds (``deferred_acks_total``);
when the window runs out the ack is withheld (``withheld_acks_total``)
and the peer resends. The port has no qos plane: a wire-stamped tenant
(``option.tenant`` / ``priority``) is validated as the reference
validates it and admitted, as the reference admits a tenant without a
bucket; the stamp is not carried onto the chunk (the port's chunks have
no stamps).

The client sends each flushed chunk as one PackedForward frame
(``option.size``, ``fluent_signal``; gzip'd with ``compress gzip``;
integer times with ``time_as_integer``) over one connection an
instance, under an asyncio lock. With ``require_ack_response`` the frame
carries ``chunk``, the content digest ``core.relay.stable_chunk_id``,
and the flush waits up to ``ack_timeout`` for the matching ack (its
round trip in ``fluentbit_forward_ack_rtt_seconds``); a resend of an id
already sent counts in ``resends_total``. ``shared_key`` runs the client
side of the handshake, ``tls`` dials through ``core.tls``. Each
destination has a circuit breaker (``engine.guard``, the service's
``guard.breaker_*`` keys); an ``upstream`` file gives a weighted HA node
set (``core.upstream``). A flush that fails (dial, handshake, write,
ack) fails over within itself, up to ``max(2, nodes)`` attempts apart
by full-jitter backoff, with the same chunk id; when every attempt
fails it returns RETRY, or, with ``storage_spool``, parks the packed
chunk in a ``core.relay.ForwardSpool`` and returns OK, and a heal task
replays the spool in order with each chunk's own id. The chunks carry no
tenant or priority stamp (the port's chunks have none), which is what
the reference sends for an unstamped chunk.
"""

from __future__ import annotations

import asyncio
import gzip
import hashlib
import logging
import os
import socket
import time
from typing import Optional

from .. import failpoints as _fp
from ..codec.events import encode_event, iter_events
from ..codec.msgpack import EventTime, OutOfData, Unpacker, packb
from ..core.config import TLS_CONFIG, ConfigMapEntry
from ..core.guard import io_deadline
from ..core.plugin import FlushResult, InputPlugin, OutputPlugin, registry
from ..core.relay import DedupLedger, ForwardSpool, stable_chunk_id
from ..core.scheduler import backoff_full_jitter
from ..core.tls import open_connection, server_context
from ..core.upstream import close_quietly, parse_upstream_file
from ..ops.device import DEVICE_ERRORS

log = logging.getLogger("flb.forward")

#: wire-stamp hygiene: the tenant name crosses a trust boundary, so it
#: is bounded before anything keys on it
_TENANT_MAX_LEN = 128
_PRIORITY_MAX = 7


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
                            "it again (durable under storage.path)"),
        ConfigMapEntry("dedup_ttl", "time", default="300",
                       desc="how long an absorbed chunk id stays in the "
                            "ledger"),
        ConfigMapEntry("defer_ack_window", "time", default="5",
                       desc="how long an ack waits while backpressure "
                            "refuses the append; then it is withheld and "
                            "the peer resends"),
    ] + TLS_CONFIG

    def init(self, instance, engine) -> None:
        self.bound_port: Optional[int] = None
        # built here, so a bad certificate or a missing tls.crt_file
        # raises from start()
        self._ssl = server_context(instance)
        self._writers: set = set()
        # set once the listener closes: a message still buffered on a
        # connection is not absorbed (its ack could not be written)
        self._closed = False
        self._ledger: Optional[DedupLedger] = None
        if self.dedup:
            self._ledger = DedupLedger(engine.service.storage_path,
                                       ttl=self.dedup_ttl)
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
            except DEVICE_ERRORS:
                # counted by the engine; the connection ends unacked
                log.exception("in_forward append hit a device error")
                raise
            except Exception:
                log.exception("in_forward connection failed")
            finally:
                self._writers.discard(writer)
                close_quietly(writer)

        server = await asyncio.start_server(handle, self.listen, self.port,
                                            ssl=self._ssl)
        self.bound_port = server.sockets[0].getsockname()[1]

        async def serve() -> None:
            try:
                await asyncio.Event().wait()
            finally:
                self._closed = True
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
                if self._closed:
                    return
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
            # a wire-stamped tenant is admitted: with no qos plane it has
            # no bucket (the stamp is not carried further)
            elif not await self._absorb(engine, tag, buf, n, cid):
                # backpressure outlasted the window: no ack, the peer's
                # ack timeout turns into its retry; the resend dedups if
                # a later pass absorbed it
                self.n_withheld_acks += 1
                self._m_withheld.inc(1, (self.instance.display_name,))
                return
        if ack_ref is not None:
            if _fp.ACTIVE:
                try:
                    # absorbed, the ack not yet written: the lost-ack
                    # window (the edge resends, the ledger dedups; the
                    # connection stays up)
                    _fp.fire("forward.ack_drop")
                except _fp.FailpointError:
                    return
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

    async def _absorb(self, engine, tag: str, buf: bytes, n: int,
                      cid: Optional[str]) -> bool:
        """Absorb one decoded chunk into engine state effectively once
        (reference :306-373), and record its id before the ack leaves.
        An append that backpressure refuses is retried every 50 ms for up
        to ``defer_ack_window`` seconds. Returns False when the window
        runs out: the caller withholds the ack. An append that raises
        closes the connection without an ack."""
        ins = self.instance
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.defer_ack_window
        led = self._ledger if cid is not None else None
        deferred = False
        while True:
            if led is not None and led.seen(cid):
                # another delivery of the chunk absorbed it while this
                # one waited: just ack
                self._m_dedup.inc(1, (ins.display_name,))
                return True
            if engine.input_log_append(ins, tag, buf, n) >= 0:
                if led is not None:
                    led.record(cid)
                self.n_absorbed += 1
                self._m_absorbed.inc(1, (ins.display_name,))
                return True
            if not deferred:
                deferred = True
                self.n_deferred_acks += 1
                self._m_deferred.inc(1, (ins.display_name,))
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False
            await asyncio.sleep(min(0.05, remaining))

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


#: what ``_flush_locked`` answers for a chunk it parked in the spool
_SPOOLED = object()


@registry.register
class ForwardOutput(OutputPlugin):
    name = "forward"
    description = "Fluentd Forward protocol client"
    config_map = [
        ConfigMapEntry("host", "str", default="127.0.0.1"),
        ConfigMapEntry("port", "int", default=24224),
        ConfigMapEntry("shared_key", "str"),
        ConfigMapEntry("self_hostname", "str"),
        ConfigMapEntry("require_ack_response", "bool", default=False),
        ConfigMapEntry("compress", "str"),
        ConfigMapEntry("time_as_integer", "bool", default=False),
        ConfigMapEntry("ack_timeout", "time", default="10"),
        ConfigMapEntry("upstream", "str",
                       desc="upstream HA definition file: weighted "
                            "[NODE] sections with failover"),
        ConfigMapEntry("storage_spool", "str",
                       desc="partition spool directory: when every "
                            "upstream refuses, packed chunks park here "
                            "and replay on heal"),
    ] + TLS_CONFIG

    def __init__(self) -> None:
        super().__init__()
        self._reader = None
        self._writer = None
        # one connection per instance: concurrent flushes must not
        # interleave writes or take each other's acks
        self._lock = asyncio.Lock()
        self._node = None
        self._cur_breaker = None
        self._cur_target = None
        self._replay_task = None
        self._replay_failures = 0
        self._spool_seq = 0
        # ids already sent once (bounded): a re-entry is a resend
        self._sent_ids: dict = {}
        self._ack_rtts: list = []
        self.n_acks_waited = 0
        self.n_acks_lost = 0
        self.n_resends = 0
        self.n_spooled = 0
        self.n_replayed = 0

    def init(self, instance, engine) -> None:
        self._engine = engine
        self._ha = None
        if self.upstream:
            self._ha = parse_upstream_file(self.upstream)
        self._spool: Optional[ForwardSpool] = None
        if self.storage_spool:
            self._spool = ForwardSpool(self.storage_spool)
        self._iname = instance.display_name
        m = engine.metrics
        self._m_waited = m.counter(
            "fluentbit", "forward", "acks_waited_total",
            "Forward flushes that waited for a chunk ack", ("instance",))
        self._m_lost = m.counter(
            "fluentbit", "forward", "acks_lost_total",
            "Acks that timed out or mismatched (flush retried)",
            ("instance",))
        self._m_resends = m.counter(
            "fluentbit", "forward", "resends_total",
            "Chunks re-sent with an already-used chunk id", ("instance",))
        self._m_spooled = m.counter(
            "fluentbit", "forward", "spooled_chunks_total",
            "Chunks degraded to the partition spool", ("instance",))
        self._m_replayed = m.counter(
            "fluentbit", "forward", "replayed_chunks_total",
            "Spooled chunks replayed and acked after heal", ("instance",))
        self._m_rtt = m.histogram(
            "fluentbit", "forward", "ack_rtt_seconds",
            "Send → ack round-trip per chunk", ("instance",))
        self._m_breaker = m.gauge(
            "fluentbit", "forward", "breaker_state",
            "Per-upstream breaker state (0 closed / 1 half-open / "
            "2 open)", ("upstream",))

    def exit(self) -> None:
        if self._replay_task is not None:
            try:
                self._replay_task.cancel()
            except RuntimeError:
                pass  # loop already closed at engine teardown
            self._replay_task = None
        if self._writer is not None:
            sock = self._writer.get_extra_info("socket")
            close_quietly(self._writer)
            if sock is not None:
                # the engine's loop has closed, so the close above could
                # not reach the socket: end the stream for the peer here
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    # -- connection -----------------------------------------------------

    def _breaker_for(self, host: str, port: int):
        name = f"forward:{host}:{port}"
        br = self._engine.guard.breaker(name)
        self._m_breaker.set(br.state_code(), (name,))
        return br

    async def _connect(self):
        if self._writer is not None and not self._writer.is_closing():
            return
        host, port = self.host, self.port
        self._node = None
        if self._ha is not None:
            self._node = self._ha.pick()
            host, port = self._node.host, self._node.port
        self._cur_target = f"forward:{host}:{port}"
        brk = self._breaker_for(host, port)
        self._cur_breaker = brk
        if not brk.allow():
            # a refusal by the breaker is no fresh evidence of failure:
            # the error path must not re-arm the cooldown for it
            self._cur_breaker = None
            raise ConnectionError(
                f"forward: breaker open for {host}:{port}")
        self._reader, self._writer = await open_connection(
            self.instance, host, port, timeout=10)
        if self.shared_key:
            await self._handshake()

    def _conn_failed(self) -> None:
        """Error-path bookkeeping: tear the socket down, mark the node
        down (HA failover on the next pick), record breaker evidence."""
        if self._writer is not None:
            close_quietly(self._writer)
        self._reader = self._writer = None
        if self._ha is not None and self._node is not None:
            self._ha.mark_down(self._node)
        if self._cur_breaker is not None:
            self._cur_breaker.record_failure()
            self._m_breaker.set(self._cur_breaker.state_code(),
                                (self._cur_target,))
            self._cur_breaker = None

    def _conn_ok(self) -> None:
        if self._ha is not None and self._node is not None:
            self._ha.mark_up(self._node)
        if self._cur_breaker is not None:
            self._cur_breaker.record_ok()
            self._m_breaker.set(self._cur_breaker.state_code(),
                                (self._cur_target,))
            self._cur_breaker = None

    async def _handshake(self) -> None:
        if _fp.ACTIVE:
            # a peer that accepts the dial but never finishes the auth
            _fp.fire("forward.handshake")
        u = Unpacker()
        helo = await self._read_msg(u)
        if not (isinstance(helo, list) and helo and helo[0] == "HELO"):
            raise ConnectionError("forward: expected HELO")
        nonce = helo[1].get("nonce", b"")
        nonce = nonce if isinstance(nonce, bytes) else str(nonce).encode()
        hostname = self.self_hostname or socket.gethostname()
        salt = os.urandom(16)
        digest = hashlib.sha512(
            salt + hostname.encode() + nonce + self.shared_key.encode()
        ).hexdigest()
        self._writer.write(packb(["PING", hostname, salt, digest, "", ""]))
        await io_deadline(self._writer.drain(), 10)
        pong = await self._read_msg(u)
        if not (isinstance(pong, list) and len(pong) >= 2
                and pong[0] == "PONG" and pong[1]):
            raise ConnectionError("forward: handshake rejected")

    async def _read_msg(self, u: Unpacker):
        while True:
            try:
                return u.unpack()
            except OutOfData:
                data = await io_deadline(self._reader.read(65536))
                if not data:
                    raise ConnectionError("forward: peer closed")
                u.feed(data)

    # -- framing --------------------------------------------------------

    def _packed_entries(self, data: bytes) -> tuple:
        """V2 events buffer → (entry stream, count, record END offsets);
        the END offsets go to the spool's sidecar."""
        out = bytearray()
        n = 0
        ends = []
        for ev in iter_events(data):
            ts = ev.timestamp
            if self.time_as_integer:
                ts = int(ev.ts_float)
            elif isinstance(ts, float):
                ts = EventTime.from_float(ts)
            out += packb([ts, ev.body])
            ends.append(len(out))
            n += 1
        return bytes(out), n, ends

    def _frame(self, tag: str, blob: bytes, n: int,
               chunk_id: Optional[str], tenant, priority) -> bytes:
        option = {"size": n, "fluent_signal": 1}
        payload = blob
        if (self.compress or "").lower() == "gzip":
            payload = gzip.compress(blob)
            option["compressed"] = "gzip"
        if tenant is not None:
            option["tenant"] = tenant
        if priority is not None:
            option["priority"] = int(priority)
        if chunk_id is not None:
            option["chunk"] = chunk_id
        return packb([tag, payload, option])

    def _note_sent(self, chunk_id: str) -> bool:
        """True on the first send of this id; False marks a resend.
        Bounded: an eviction only ever under-counts resends."""
        if chunk_id in self._sent_ids:
            return False
        if len(self._sent_ids) >= 4096:
            for k in list(self._sent_ids)[:256]:
                del self._sent_ids[k]
        self._sent_ids[chunk_id] = True
        return True

    # -- delivery -------------------------------------------------------

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        async with self._lock:
            result = await self._flush_locked(data, tag)
        if result is _SPOOLED:
            # the heal task takes the lock itself, chunk by chunk
            self._ensure_replay()
            return FlushResult.OK
        return result

    async def _flush_locked(self, data: bytes, tag: str) -> FlushResult:
        blob, n, ends = self._packed_entries(data)
        if n == 0:
            return FlushResult.OK
        chunk_id = None
        if self.require_ack_response:
            chunk_id = stable_chunk_id(tag, blob)
            if not self._note_sent(chunk_id):
                self.n_resends += 1
                self._m_resends.inc(1, (self._iname,))
        wire = self._frame(tag, blob, n, chunk_id, None, None)
        budget = max(2, len(self._ha.nodes)) if self._ha is not None \
            else 2
        attempt = 0
        while True:
            attempt += 1
            try:
                await self._connect()
                await self._send_chunk(wire, chunk_id)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self._conn_failed()
                if attempt >= budget:
                    break
                # the retry reuses the same chunk id: a delivery whose
                # ack was lost dedups at the aggregator
                await asyncio.sleep(backoff_full_jitter(0.05, 0.5, attempt))
                continue
            self._conn_ok()
            return FlushResult.OK
        return self._degrade(tag, blob, ends, chunk_id)

    async def _send_chunk(self, wire: bytes,
                          chunk_id: Optional[str]) -> None:
        if _fp.ACTIVE:
            # the connection torn before any byte of the frame (a reset)
            _fp.fire("forward.conn_reset")
            d = _fp.fire("forward.partial_write")
            if d and d[0] == "partial":
                # the frame cut after n bytes, then the link dies: the
                # receiver must drop the torn tail without absorbing it
                self._writer.write(wire[: max(1, int(d[1]))])
                await io_deadline(self._writer.drain())
                raise ConnectionError("forward: injected partial write")
        self._writer.write(wire)
        await io_deadline(self._writer.drain())
        if chunk_id is None:
            return
        u = Unpacker()
        self.n_acks_waited += 1
        self._m_waited.inc(1, (self._iname,))
        t0 = time.monotonic()
        try:
            ack = await asyncio.wait_for(self._read_msg(u),
                                         timeout=self.ack_timeout)
        except asyncio.TimeoutError:
            # a peer alive on TCP but hung: failed over like a dial
            self.n_acks_lost += 1
            self._m_lost.inc(1, (self._iname,))
            raise
        if not (isinstance(ack, dict) and ack.get("ack") == chunk_id):
            self.n_acks_lost += 1
            self._m_lost.inc(1, (self._iname,))
            raise ConnectionError("forward: ack mismatch")
        rtt = time.monotonic() - t0
        self._ack_rtts.append(rtt)
        if len(self._ack_rtts) > 256:
            del self._ack_rtts[:128]
        self._m_rtt.observe(rtt, (self._iname,))
        if _fp.ACTIVE:
            try:
                _fp.fire("forward.dup_delivery")
            except _fp.FailpointError:
                # an ambiguous ack: the same frame delivered again after
                # its ack (the aggregator's ledger absorbs it zero
                # times; its ack is read here, not taken for the next
                # chunk's)
                self.n_resends += 1
                self._m_resends.inc(1, (self._iname,))
                self._writer.write(wire)
                await io_deadline(self._writer.drain())
                await asyncio.wait_for(self._read_msg(u),
                                       timeout=self.ack_timeout)

    # -- partition degrade + heal replay --------------------------------

    def _degrade(self, tag: str, blob: bytes, ends,
                 chunk_id: Optional[str]):
        """Every attempt of this flush failed. With a spool, park the
        packed chunk on disk (``_SPOOLED``: the flush starts the heal
        replay and answers OK); otherwise RETRY through the engine's
        backoff."""
        if self._spool is None:
            return FlushResult.RETRY
        self._spool_seq += 1
        self._spool.put(tag, blob, ends, {
            "tag": tag, "chunk": chunk_id, "tenant": None,
            "priority": None,
            # the reference's storage-quota charge id: kept, so either
            # package replays the other's spool as its own
            "quota_id": f"fwd-spool:{self._iname}:{self._spool_seq}",
        })
        self.n_spooled += 1
        self._m_spooled.inc(1, (self._iname,))
        return _SPOOLED

    def _ensure_replay(self) -> None:
        if self._replay_task is None or self._replay_task.done():
            self._replay_task = asyncio.get_running_loop().create_task(
                self._replay_spool())

    async def _replay_spool(self) -> None:
        """Heal replay: drain the spool in spool order, each chunk
        framed from its sidecars (``ForwardSpool.load``) and sent with
        its own chunk id, so a replay that races a delivery from before
        the partition dedups at the aggregator."""
        spool = self._spool
        while True:
            files = spool.pending()
            if not files:
                self._replay_failures = 0
                return
            progressed = False
            for f in files:
                got = spool.load(f)
                if got is None:
                    spool.drop(f)  # unframeable: nothing to replay
                    continue
                blob, n, meta = got
                cid = meta.get("chunk")
                wire = self._frame(meta.get("tag") or "", blob, n, cid,
                                   meta.get("tenant"),
                                   meta.get("priority"))
                async with self._lock:
                    if cid is not None and not self._note_sent(cid):
                        self.n_resends += 1
                        self._m_resends.inc(1, (self._iname,))
                    try:
                        await self._connect()
                        await self._send_chunk(wire, cid)
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        self._conn_failed()
                        break
                    self._conn_ok()
                spool.drop(f)
                self.n_replayed += 1
                self._m_replayed.inc(1, (self._iname,))
                progressed = True
            if progressed:
                self._replay_failures = 0
            else:
                self._replay_failures += 1
                await asyncio.sleep(backoff_full_jitter(
                    0.1, 1.0, self._replay_failures))

    # -- health ---------------------------------------------------------

    def ack_p50(self) -> Optional[float]:
        if not self._ack_rtts:
            return None
        s = sorted(self._ack_rtts)
        return s[len(s) // 2]

    def health_block(self) -> dict:
        out = {
            "role": "client",
            "acks_waited": self.n_acks_waited,
            "acks_lost": self.n_acks_lost,
            "resends": self.n_resends,
            "spooled": self.n_spooled,
            "replayed": self.n_replayed,
        }
        upstreams = {}
        if self._ha is not None:
            for node in self._ha.nodes:
                upstreams[f"{node.host}:{node.port}"] = \
                    node.breaker.state_name()
        else:
            br = self._engine.guard.breaker(
                f"forward:{self.host}:{self.port}")
            upstreams[f"{self.host}:{self.port}"] = br.state_name()
        out["upstreams"] = upstreams
        if self._spool is not None:
            out["spool_pending"] = len(self._spool.pending())
        p50 = self.ack_p50()
        if p50 is not None:
            out["ack_p50_ms"] = round(p50 * 1000.0, 3)
        return out
