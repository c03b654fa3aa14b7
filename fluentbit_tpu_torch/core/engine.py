"""The engine — event loop, ingest path, dispatch, flush.

The port's counterpart of ``fluentbit_tpu/core/engine.py``:
``input_log_append`` → raw chunk path (when every filter of the tag can
take it: matching and compaction straight off the msgpack bytes, no
decode) or decode → filter chain → chunk pool,
typed appends (``input_event_append``: metrics snapshots, no filter
chain), hidden inputs (the emitters that log_to_metrics and flux feed),
the named parsers (``parsers``, ``parser()``) that filter_parser and
in_tail look up, server inputs listening on the engine's loop, and a
flush timer that drains the pools to the outputs, with the grace window
at stop. The engine's ``metrics`` registry holds the flux families, and
``_ingest_src`` names the input whose append the filter chain is running
(flux skips its own emitter's rows by it). The stream processor
(``sp_task``) runs on each append's filtered events, after the filter
chain; a sketch-eligible query reads a hidden flux filter's state
instead. The raw path runs each filter's batch hook (``process_batch``)
or raw filter (``filter_raw``); a chain of ``thread_safe_raw`` filters
runs under the input's own lock, so inputs append in parallel. The
input and filter counter families (``fluentbit_input_*``,
``fluentbit_filter_*``) count on both paths.

Delivery: each flush cycle drains the backlog, then each input's pool,
into tasks (``Task``, one a chunk, with its routes) in a bounded task
map; a full map parks the chunk and the rest of the cycle on the
backlog. Each route's flush is spawned through a priority bucket queue
and may run on the output's worker threads. An output's RETRY arms a
loop timer with full-jitter backoff (``_schedule_retry``; no coroutine
waits), up to ``retry_limit`` times, then the chunk drops and counts; an
output's ``route_condition`` splits the decoded records into chunks per
route mask at ingest. The output counter families, the uptime gauge and
the delivery latency histogram count it. ``guard`` (``core/guard.py``)
gives every tracked flush a deadline, a breaker to every output (and to
the forward output's destinations), and rides the flush timer with its
watchdog and breaker shedding; ``reload_count`` / ``reload_callback``
are the CLI's full-restart reloads. The failpoint plane
(``failpoints/``) has its sites here (``engine.flush_dispatch``,
``engine.retry_schedule``, ``output.flush[.<output>]``) and its
triggers count in ``fluentbit_failpoint_triggered_total``.

The host error policy is the reference's: a filter that raises is
logged and its records pass on, a batch hook that raises is logged and
declines, a raw chain's bytes that do not decode are appended as they
are, and a stream-processor task or flux attach that fails is logged. A
device error (``ops.device.DEVICE_ERRORS``: a failed build or launch) is
none of these: the engine counts it in
``fluentbit_device_launch_failures_total{lane}`` and it reaches the
caller of the append. Qos, processors, chunk trace, reload by diff, the
admin HTTP server and multiline wait for later slices.

Storage and input backpressure: with the service's ``storage.path`` the
engine keeps a ``core.storage.Storage`` and loads its backlog at
``start()``, before the first flush. A ``storage.type filesystem``
input's appends are written through on every append path
(``_persist``), each drained chunk is finalized with its CRC, its file
is deleted when the last route delivers it, and a chunk that drops (an
error, retries exhausted, a stop with its flush undelivered) is
quarantined into the DLQ. ``input_log_append`` puts backpressure first:
over the input's ``mem_buf_limit``, or over the service's
``storage.max_chunks_up`` chunks with ``storage.pause_on_chunks_overlimit``,
it pauses the input and returns -1; a ``memrb`` input evicts its oldest
chunks instead (``fluentbit_input_memrb_dropped_*``). The flush resumes a
paused input once its pool is under the limits; a paused input's
collector skips its collect, and ``threaded on`` runs the collector on a
thread of its own.

Reference: src/flb_engine.c (flb_engine_start event loop),
src/flb_engine_dispatch.c (chunk → task → per-route flush),
src/flb_task.c (task refcounting and retries), src/flb_input_chunk.c
(ingest + synchronous filter chain at append, :3078). The engine is a
host-side asyncio loop in its own thread; the filter chain runs
synchronously in the appending thread. Device work happens inside filters
on ``engine.device``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from .. import failpoints as _fp
from ..codec.chunk import Chunk
from ..codec.events import (LogEvent, decode_events, fast_count_records,
                            reencode_event)
from ..ops.device import DEVICE_ERRORS
from . import guard as _guard
from .bucket_queue import PRIORITY_FLUSH, PRIORITY_TOP, BucketQueue
from .chunk_batch import RawChunk
from .config import ServiceConfig
from .metrics import MetricsRegistry
from .output_thread import OutputWorkerPool
from .plugin import (
    FilterInstance,
    FilterResult,
    FlushResult,
    InputInstance,
    OutputInstance,
    registry as default_registry,
)
from .scheduler import backoff_full_jitter

log = logging.getLogger("flb.engine")

_task_ids = itertools.count(1)


class Task:
    """One flushable chunk and its routes' retry counts (reference
    ``Task``, fluentbit_tpu/core/engine.py:57-72; struct flb_task,
    include/fluent-bit/flb_task.h:82-98). ``users`` counts the routes
    still to finish; the last one frees the task's slot."""

    __slots__ = ("id", "chunk", "retries", "users")

    def __init__(self, chunk: Chunk, users: int):
        self.id = next(_task_ids)
        self.chunk = chunk
        self.retries: Dict[str, int] = {}  # output name → attempts
        self.users = users


class _RawTail:
    """What ``_ingest_raw`` hands back when a filter declines after a
    ``stateful_batch`` hook has committed its effects (reference
    ``_RawTail``, fluentbit_tpu/core/engine.py:75): the remaining
    filters finish on the decoded records of the current bytes
    (``_finish_raw_tail``), with no raw-path lock held, since the tail
    takes the engine's lock and the order is Engine lock, then input
    lock."""

    __slots__ = ("tag", "data", "remaining", "n", "n_records", "deltas",
                 "in_bytes")

    def __init__(self, tag, data, remaining, n, n_records, deltas,
                 in_bytes):
        self.tag = tag
        self.data = data
        self.remaining = remaining  # the declining filter onward
        self.n = n  # the records of ``data``, None when not yet counted
        self.n_records = n_records
        self.deltas = deltas
        self.in_bytes = in_bytes


def _lane_of(plugin) -> str:
    """The device lane of a filter's errors that carry none: ``flux``
    for the sketch filters, ``grep`` for the matchers."""
    return "flux" if plugin.name in ("flux", "log_to_metrics") else "grep"


class Engine:
    """The pipeline runtime for one configuration context."""

    def __init__(self, service: Optional[ServiceConfig] = None,
                 device: Optional[torch.device] = None, registry=None):
        self.service = service or ServiceConfig()
        self.device = device
        self.registry = registry or default_registry
        self.inputs: List[InputInstance] = []
        self.filters: List[FilterInstance] = []
        self.outputs: List[OutputInstance] = []
        # filesystem storage (core/storage.py), made by start() when the
        # service has a storage.path
        self.storage = None
        self.metrics = MetricsRegistry()
        self._init_metrics()
        self.parsers: Dict[str, Any] = {}  # named parsers (flb_parser registry)
        self._ingest_src: Optional[InputInstance] = None  # under the lock
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopping = False
        self._stop_event = threading.Event()  # wakes threaded collectors
        # serializes ingest (filters + pool appends) against pool drains;
        # reentrant because a filter may append from inside the chain
        # (log_to_metrics emits its snapshot through input_event_append)
        self._ingest_lock = threading.RLock()
        self._start_error: Optional[BaseException] = None
        self._pending_flushes: set = set()
        # chunks a full task map parked, dispatched first next cycle
        self._backlog: List[Chunk] = []
        # retries in backoff: a loop timer each, keyed (chunk id, output
        # name), no coroutine (flb_engine_dispatch_retry,
        # src/flb_engine_dispatch.c:36-99)
        self._pending_retries: Dict[tuple, tuple] = {}
        # ready loop callbacks in priority order: retry fires (top) go
        # before flush spawns (flush)
        self._event_queue = BucketQueue()
        self._event_queue_lock = threading.Lock()
        # the bounded task map (flb_task_map, src/flb_task.c:542)
        self._task_map: Dict[int, Task] = {}
        self._task_lock = threading.Lock()
        self._task_map_warned = 0.0
        self.started_at = 0.0
        self.sp = None  # the stream processor, made by the first sp_task
        # the CLI's full-restart reloads so far, and its SIGHUP hook
        # (reference core/engine.py:142, :164)
        self.reload_count = 0
        self.reload_callback = None
        # flush deadlines, a breaker on every output, the watchdog and
        # breaker shedding (core/guard.py)
        self.guard = _guard.Guard(self)

    def _init_metrics(self) -> None:
        """The input, filter and output families, the uptime gauge and
        the latency histogram of the reference's ``_init_metrics``
        (fluentbit_tpu/core/engine.py:185-221)."""
        m = self.metrics
        self.m_in_records = m.counter("fluentbit", "input", "records_total",
                                      "Input records", ("name",))
        self.m_in_bytes = m.counter("fluentbit", "input", "bytes_total",
                                    "Input bytes", ("name",))
        self.m_filter_add = m.counter(
            "fluentbit", "filter", "add_records_total",
            "Records added by filter", ("name",))
        self.m_filter_drop = m.counter(
            "fluentbit", "filter", "drop_records_total",
            "Records dropped by filter", ("name",))
        self.m_filter_emit = m.counter(
            "fluentbit", "filter", "emit_records_total",
            "Records re-emitted by filter", ("name",))
        # a decline is invisible in the output by contract: this counter
        # shows which appends left the raw path
        self.m_filter_batch_decline = m.counter(
            "fluentbit", "filter", "batch_declines_total",
            "Batched fast-path declines to the per-record path",
            ("name",))
        self.m_out_proc_records = m.counter(
            "fluentbit", "output", "proc_records_total",
            "Records delivered", ("name",))
        self.m_out_proc_bytes = m.counter(
            "fluentbit", "output", "proc_bytes_total", "Bytes delivered",
            ("name",))
        self.m_out_errors = m.counter("fluentbit", "output", "errors_total",
                                      "Flush errors", ("name",))
        self.m_out_retries = m.counter("fluentbit", "output",
                                       "retries_total", "Flush retries",
                                       ("name",))
        self.m_out_retries_failed = m.counter(
            "fluentbit", "output", "retries_failed_total",
            "Retries exhausted", ("name",))
        self.m_out_dropped = m.counter(
            "fluentbit", "output", "dropped_records_total",
            "Records dropped at output", ("name",))
        self.m_uptime = m.gauge("fluentbit", "", "uptime", "Uptime seconds")
        # memrb eviction (src/flb_input_chunk.c:2936-2966; reference :221)
        self.m_memrb_dropped_chunks = m.counter(
            "fluentbit", "input", "memrb_dropped_chunks_total",
            "Chunks evicted by memrb ring buffer", ("name",))
        self.m_memrb_dropped_bytes = m.counter(
            "fluentbit", "input", "memrb_dropped_bytes_total",
            "Bytes evicted by memrb ring buffer", ("name",))
        # chunk creation → delivery (reference src/flb_engine.c:400-405)
        self.m_latency = m.histogram(
            "fluentbit", "output", "latency_seconds",
            "chunk create → delivered latency", ("name",))
        # every armed failpoint that fires (reference :232)
        self.m_failpoint_triggered = m.counter(
            "fluentbit", "", "failpoint_triggered_total",
            "Faults triggered by the failpoint plane", ("name",))
        # a device error that passed through the engine to the caller of
        # an append, by lane: grep (the DFA matchers) or flux (the
        # sketch and window kernels) (reference :248)
        self.m_device_failures = m.counter(
            "fluentbit", "device", "launch_failures_total",
            "Device launches that raised (XlaRuntimeError, injected "
            "faults, resource exhaustion)", ("lane",))

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def _make_instance(self, create, name: str, props, peers):
        ins = create(name)
        n = sum(1 for p in peers if p.plugin.name == ins.plugin.name)
        ins.name = f"{ins.plugin.name}.{n}"
        pool = getattr(ins, "pool", None)
        if pool is not None:
            pool.in_name = ins.name  # the storage stream's directory
        for k, v in props.items():
            ins.set(k, v)
        return ins

    # the instance lists are replaced, never mutated in place: the flush
    # timer and ingest iterate them without a lock

    def input(self, name: str, **props) -> InputInstance:
        ins = self._make_instance(self.registry.create_input, name, props,
                                  self.inputs)
        self.inputs = self.inputs + [ins]
        return ins

    def filter(self, name: str, **props) -> FilterInstance:
        ins = self._make_instance(self.registry.create_filter, name, props,
                                  self.filters)
        # the hidden flux filters of SQL queries stand in for the stream
        # processor, which runs after the filter chain: a filter added
        # later still goes before them
        pos = len(self.filters)
        while pos and getattr(self.filters[pos - 1], "_flux_sql_hidden",
                              False):
            pos -= 1
        with self._ingest_lock:
            self.filters = self.filters[:pos] + [ins] + self.filters[pos:]
        return ins

    def output(self, name: str, **props) -> OutputInstance:
        ins = self._make_instance(self.registry.create_output, name, props,
                                  self.outputs)
        self.outputs = self.outputs + [ins]
        return ins

    def parser(self, name: str, **props):
        """Create + register a named parser (flb_parser_create)."""
        from ..parsers import create_parser

        p = create_parser(name, **props)
        self.parsers[p.name] = p
        return p

    def hidden_input(self, name: str, **props) -> InputInstance:
        """Create and initialize an internal input at once: the hidden
        ``emitter`` a filter's init makes for itself (reference
        plugins/filter_rewrite_tag/rewrite_tag.c:245-260)."""
        ins = self._make_instance(self.registry.create_input, name, props,
                                  self.inputs)
        with self._ingest_lock:
            self.inputs = self.inputs + [ins]
        ins.configure()
        ins.plugin.init(ins, self)
        ins._initialized = True  # start() leaves it as it is
        return ins

    def hidden_filter(self, name: str, preset_state, **props
                      ) -> FilterInstance:
        """Create, initialize and append the hidden flux filter of an SQL
        query (``flux.query.attach_flux``): it absorbs into
        ``preset_state``, stays at the tail of the chain, and
        ``start()`` does not initialize it again."""
        ins = self._make_instance(self.registry.create_filter, name, props,
                                  self.filters)
        ins.plugin._preset_state = preset_state
        ins.plugin._sql_mode = True
        ins._flux_sql_hidden = True
        ins.configure()
        ins.plugin.init(ins, self)
        ins._initialized = True
        with self._ingest_lock:
            self.filters = self.filters + [ins]
        return ins

    def sp_task(self, sql: str, allow_flux: bool = True):
        """Register a stream-processor query (flb_sp_create task;
        [STREAM_TASK] Exec). The SP runs synchronously after the filter
        chain at ingest (src/flb_input_chunk.c:3155) and its window timer
        rides a 0.5 s collector on the SP's hidden emitter, scheduled
        here when the engine already runs.

        A sketch-eligible query resolves against the flux plane
        (``flux.query.attach_flux``): a hidden ``flux`` filter keeps the
        aggregation state on the engine's device, and the task reads its
        windows from it. ``allow_flux=False``, ``WITH (flux='off')`` or
        ``FBTPU_FLUX_SQL=off`` pin the exact per-event evaluation. When
        ``attach_flux`` raises, the error is logged and the query stays
        on the exact path, as in the reference; a device error raises."""
        from ..stream_processor import StreamProcessor

        if self.sp is None:
            self.sp = StreamProcessor(self)
        task = self.sp.create_task(sql)
        if allow_flux and os.environ.get(
                "FBTPU_FLUX_SQL", "on").lower() not in ("0", "off"):
            from ..flux.query import attach_flux

            try:
                attach_flux(self, task)
            except DEVICE_ERRORS as exc:
                self.sp.tasks.remove(task)
                self._count_device_error(exc, "flux")
                raise
            except Exception:
                log.exception("flux attach failed; query %r stays on the "
                              "exact evaluation path", sql)
        if self.sp._emitter is None:
            ins = self.hidden_input("emitter",
                                    alias="emitter_for_stream_processor")
            self.sp._emitter = ins.plugin
            self.sp.emitter_instance = ins
            sp = self.sp

            def _tick(_engine):
                with self._ingest_lock:
                    sp.tick()

            ins.plugin.collect_interval = 0.5
            ins.plugin.collect = _tick
            self.ensure_collector(ins)
        return task

    def ensure_collector(self, ins: InputInstance) -> None:
        """Schedule the interval collector of an input made after
        ``start()`` (``_main`` schedules the others)."""
        loop = self.loop
        if not self.running or loop is None \
                or ins.plugin.collect_interval is None:
            return

        def _schedule():
            if ins.collector_task is None and not self._stopping:
                ins.collector_task = asyncio.ensure_future(
                    self._collector(ins))

        try:
            loop.call_soon_threadsafe(_schedule)
        except RuntimeError:  # loop closed mid-stop
            pass

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Make the storage and load its backlog, init every instance and
        the outputs' worker pools, then spawn the engine thread
        (flb_start; flb_storage_create at src/flb_engine.c:979,
        sb_segregate_chunks at :1129). A worker pool that does not start
        within ``guard.worker_start_timeout`` fails its output over to
        flushes on the engine's loop."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self.service.storage_path and self.storage is None:
            from .storage import Storage

            self.storage = Storage(self.service.storage_path,
                                   checksum=self.service.storage_checksum)
        if self.storage is not None:
            with self._ingest_lock:
                self._backlog = self.storage.scan_backlog()
        for ins in self.inputs + self.filters + self.outputs:
            if getattr(ins, "_initialized", False):
                continue  # hidden instances are initialized at creation
            ins.configure()
            ins.plugin.init(ins, self)
        for out in self.outputs:
            self._ensure_worker_pool(out)
        self.started_at = time.time()
        self.guard.heartbeat = time.time()
        # the failpoint trigger → metric bridge (walked only when a
        # fault fires)
        _fp.add_listener(self._on_failpoint_trigger)
        self._stopping = False
        self._stop_event.clear()
        self._start_error = None
        self._thread = threading.Thread(target=self._run, name="flb-engine",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("engine failed to start")
        if self._start_error is not None:
            self._thread.join(timeout=10)
            self._thread = None
            self._stop_worker_pools()
            _fp.remove_listener(self._on_failpoint_trigger)
            raise RuntimeError("engine failed to start") from self._start_error

    def _ensure_worker_pool(self, out: OutputInstance) -> None:
        """The output's worker threads (flb_output_thread_pool_create,
        src/flb_output_thread.c:472), when ``workers`` is set and the
        plugin is not synchronous. A pool whose workers do not all start
        within ``guard.worker_start_timeout`` is stopped, counted in
        ``fluentbit_guard_worker_start_failures_total``, and the output
        flushes on the engine's loop (reference :657-680)."""
        if out.workers <= 0 or out.worker_pool is not None \
                or out.plugin.synchronous:
            return
        pool = OutputWorkerPool(
            out.display_name, out.workers, out.plugin,
            start_timeout=self.service.guard_worker_start_timeout)
        if pool.failed:
            log.error("output %s: worker pool startup failed; failing "
                      "over to inline flush", out.display_name)
            self.guard.m_worker_start_fail.inc(1, (out.display_name,))
            pool.stop()
        else:
            out.worker_pool = pool

    def _stop_worker_pools(self) -> None:
        for out in self.outputs:
            if out.worker_pool is not None:
                out.worker_pool.stop()
                out.worker_pool = None

    def _run(self) -> None:
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self._main())
        finally:
            self.loop.close()

    async def _main(self) -> None:
        try:
            for ins in self.inputs:
                if ins.plugin.collect_interval is not None:
                    if ins.threaded:
                        # FLB_INPUT_THREADED (src/flb_input_thread.c:225):
                        # the collect runs on a thread of its own
                        ins.collector_thread = threading.Thread(
                            target=self._collector_thread, args=(ins,),
                            daemon=True, name=f"flb-in-{ins.display_name}")
                        ins.collector_thread.start()
                    else:
                        ins.collector_task = asyncio.ensure_future(
                            self._collector(ins))
                elif getattr(ins.plugin, "server_task_needed", False):
                    # bind before start() returns, so a caller can read
                    # bound_port; the task serves until stop() cancels it
                    ins.collector_task = asyncio.ensure_future(
                        await ins.plugin.start_server(self))
        except Exception as exc:  # reported by start(), which raises
            self._start_error = exc
            self._stopping = True
        self._started.set()
        flush_interval = max(0.02, self.service.flush)
        try:
            while not self._stopping:
                await asyncio.sleep(flush_interval)
                self.flush_all()
            # threaded collectors stop first: what they append must land
            # before the drain below
            self._stop_event.set()
            for ins in self.inputs:
                t = ins.collector_thread
                if t is not None and t.is_alive():
                    await asyncio.get_running_loop().run_in_executor(
                        None, t.join, self.service.grace + 2.0)
            # the server inputs stop first, listeners and connections:
            # what one acked after the drain below would never be flushed
            # (the reference drains first and keeps acking)
            servers = [ins.collector_task for ins in self.inputs
                       if ins.collector_task is not None
                       and getattr(ins.plugin, "server_task_needed", False)]
            for task in servers:
                task.cancel()
            if servers:
                await asyncio.gather(*servers, return_exceptions=True)
            # graceful drain (grace period, src/flb_engine.c:1137-1160);
            # the shed chunks go back to the backlog first
            self.guard.readmit_all()
            self.flush_all()
            await asyncio.sleep(0.05)  # let queued flush spawns run
            deadline = time.time() + self.service.grace
            while self._pending_flushes and time.time() < deadline:
                await asyncio.sleep(0.02)
            for fut in list(self._pending_flushes):
                fut.cancel()
            if self._pending_flushes:
                await asyncio.gather(*self._pending_flushes,
                                     return_exceptions=True)
            # retries still in backoff: cancel their timers and count
            # each as dropped
            for task, out, handle in list(self._pending_retries.values()):
                handle.cancel()
                self._drop_retry(task, out)
            self._pending_retries.clear()
        finally:
            self._stopping = True
            self._stop_event.set()
            for ins in self.inputs:
                t = ins.collector_thread
                if t is not None and t.is_alive():
                    t.join(timeout=2.0)
            pending = [ins.collector_task for ins in self.inputs
                       if ins.collector_task is not None]
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            self._started.clear()

    async def _collector(self, ins: InputInstance) -> None:
        """Interval collector (flb_input_set_collector_time). A paused
        input's collect is skipped. A collect that raises is logged and
        the next one runs; a device error ends the collector with it."""
        while True:
            try:
                if not ins.paused:
                    ins.plugin.collect(self)
            except DEVICE_ERRORS:
                log.exception("input %s collect hit a device error; its "
                              "collector stops", ins.display_name)
                raise
            except Exception:
                log.exception("input %s collect failed", ins.display_name)
            await asyncio.sleep(ins.plugin.collect_interval)

    def _collector_thread(self, ins: InputInstance) -> None:
        """A threaded input's collector (reference :838-860,
        input_thread_instance_create, src/flb_input_thread.c:225): the
        same loop off the engine's loop, woken by the stop."""
        interval = ins.plugin.collect_interval or 1.0
        while not self._stopping:
            try:
                if not ins.paused:
                    ins.plugin.collect(self)
            except DEVICE_ERRORS:
                log.exception("input %s collect hit a device error; its "
                              "collector stops", ins.display_name)
                raise
            except Exception:
                log.exception("input %s collect failed", ins.display_name)
            if self._stop_event.wait(interval):
                break

    def request_stop(self) -> None:
        """Ask the engine loop to stop gracefully (out_exit's stop): the
        loop drains and ends; ``stop()`` joins the thread."""
        self._stopping = True

    def stop(self) -> None:
        """Graceful stop with drain (flb_stop)."""
        if self._thread is None:
            return
        self._stopping = True
        self._thread.join(timeout=self.service.grace + 10)
        if self._thread.is_alive():
            self._dump_stuck_shutdown()
        self._thread = None
        try:
            if self.sp is not None and self.sp.tasks:
                # the open SQL windows: their rows go through the chain
                # and are flushed here, the engine thread having ended
                with self._ingest_lock:
                    self.sp.drain()
                self.flush_all()
        finally:
            self._stop_worker_pools()
            device_error = None
            for ins in self.inputs + self.filters + self.outputs:
                try:
                    ins.plugin.exit()
                except DEVICE_ERRORS as exc:
                    # the other instances still exit; the first device
                    # error (a flux drain's emit) raises after them
                    self._count_device_error(exc, _lane_of(ins.plugin))
                    device_error = device_error or exc
                except Exception:
                    log.exception("%s exit failed", ins.display_name)
            try:
                if self.storage is not None:
                    self.storage.close()
            finally:
                _fp.remove_listener(self._on_failpoint_trigger)
            if device_error is not None:
                raise device_error

    def _dump_stuck_shutdown(self) -> None:
        """The engine thread outlived ``grace`` + 10 s at ``stop()``: say
        so, and dump every thread's stack with faulthandler (reference
        :932-948)."""
        import faulthandler
        import sys

        log.warning(
            "engine thread did not exit within %.1fs at stop(): shutdown "
            "is stuck; dumping all thread stacks to stderr",
            self.service.grace + 10)
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            log.exception("thread stack dump failed")

    def _on_failpoint_trigger(self, name: str, _action: str) -> None:
        self.m_failpoint_triggered.inc(1, (name,))

    def _count_device_error(self, exc: BaseException, lane: str) -> None:
        """Count a device error once, under its lane (a ``DeviceError``
        names its own; ``lane`` is the caller's for torch's errors), as
        it passes through the engine on its way to the caller."""
        if getattr(exc, "_fbtpu_counted", False):
            return
        self.m_device_failures.inc(1, (getattr(exc, "lane", lane),))
        try:
            exc._fbtpu_counted = True
        except AttributeError:
            pass

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------------
    # ingest path (reference: flb_input_log_append → input_chunk_append_raw)
    # ------------------------------------------------------------------

    def input_log_append(self, ins: InputInstance, tag: Optional[str],
                         data: bytes, n_records: Optional[int] = None) -> int:
        """Append encoded log events: run the filter chain synchronously
        (src/flb_input_chunk.c:3078) and write the survivors into the
        input's chunk pool. Returns the records written, or -1 when
        backpressure refused the append (reference :979-1055): the pool
        holds ``mem_buf_limit`` bytes or more, or, with
        ``storage.pause_on_chunks_overlimit``, the service's
        ``storage.max_chunks_up`` chunks or more; the input is paused
        then, and the flush resumes it. A ``memrb`` input never pauses:
        its oldest chunks are evicted to make room for the append's
        bytes, and counted.

        When every filter whose route matches the tag has a raw hook
        (``can_filter_raw()`` or ``can_process_batch()``), no exact
        stream-processor task matches it and no output that matches it
        has a ``route_condition`` (the reference's ``raw_ok`` gate,
        fluentbit_tpu/core/engine.py:1076-1089, with no processors or
        trace in the port), the chain runs on the raw bytes
        (``_ingest_raw``): under the input's own lock when every filter
        is ``thread_safe_raw`` and none ``stateful_batch``, else under
        the engine's. A filter that
        declines sends the append down the decoded path: decode, filter
        chain, the stream processor on the kept events, re-encode of
        modified events; after a committed stateful hook only the
        remaining filters run there. A flux-backed SQL task does not
        force the decoded path: its hidden flux filter absorbs inside
        the chain.

        A filter that raises is logged and its records pass on; a hook
        that raises is logged and declines; a stream-processor task that
        raises is logged and the append's records are kept: the
        reference's policy. A device error (``DEVICE_ERRORS``) is counted
        in ``fluentbit_device_launch_failures_total`` and raises to the
        caller."""
        tag = tag or ins.tag or ins.plugin.name
        # backpressure first (mem_buf_limit, src/flb_input.c:157,740-746;
        # storage.pause_on_chunks_overlimit, :169), the pool's counts
        # read under the input's lock
        with ins.ingest_lock:
            over = ins.storage_type != "memrb" and ((
                ins.mem_buf_limit
                and ins.pool.pending_bytes >= ins.mem_buf_limit
            ) or (
                ins.pause_on_chunks_overlimit
                and ins.pool.pending_chunks
                >= self.service.storage_max_chunks_up))
        if over:
            ins.set_paused(True)
            return -1
        if ins.storage_type == "memrb":
            # a ring buffer: the oldest chunks make room, sized on the
            # append's incoming bytes as the reference's pre-filter check
            limit = ins.mem_buf_limit or 10 * 1024 * 1024
            with ins.ingest_lock:
                need = ins.pool.pending_bytes + len(data) - limit
                evicted = ins.pool.evict_oldest(need) if need > 0 else []
            for c in evicted:
                self.m_memrb_dropped_chunks.inc(1, (ins.display_name,))
                self.m_memrb_dropped_bytes.inc(c.size, (ins.display_name,))
        matching = [f for f in self.filters if f.route.matches(tag)]
        sp = self.sp
        sp_active = (sp is not None and ins is not sp.emitter_instance
                     and any(t.matches(tag) and t.flux is None
                             for t in sp.tasks))
        # a per-record route split needs the decoded records
        cond_routing = any(o.route_condition is not None
                           and o.route.matches(tag) for o in self.outputs)
        if not sp_active and not cond_routing and all(
                f.plugin.can_filter_raw() or f.plugin.can_process_batch()
                for f in matching):
            parallel = all(f.plugin.thread_safe_raw
                           and not f.plugin.stateful_batch
                           for f in matching)
            if parallel:
                with ins.ingest_lock:
                    got = self._ingest_raw(ins, tag, data, matching,
                                           n_records)
            else:
                with self._ingest_lock:
                    # saved and restored: an emitter re-enters this
                    # method from inside the chain
                    prev_src, self._ingest_src = self._ingest_src, ins
                    try:
                        got = self._ingest_raw(ins, tag, data, matching,
                                               n_records)
                    finally:
                        self._ingest_src = prev_src
            if isinstance(got, _RawTail):
                # a decline after committed effects: finish outside the
                # raw path's lock scope
                got = self._finish_raw_tail(ins, got)
            if got is not None:
                return got
        with self._ingest_lock:
            return self._log_append_decoded(ins, tag, data, n_records,
                                            cond_routing)

    def _log_append_decoded(self, ins: InputInstance, tag: str, data: bytes,
                            n_records: Optional[int],
                            cond_routing: bool) -> int:
        """The decoded path of ``input_log_append`` (under the engine's
        lock): decode, count the input, filter chain, stream processor,
        pool append (split by route mask under ``cond_routing``)."""
        sp = self.sp
        sp_on = sp is not None and ins is not sp.emitter_instance
        # saved and restored: an emitter re-enters input_log_append from
        # inside the chain, and the outer chain's remaining filters must
        # see the outer append's source again
        prev_src, self._ingest_src = self._ingest_src, ins
        try:
            events = decode_events(data)
            self.m_in_records.inc(
                len(events) if n_records is None else n_records,
                (ins.display_name,))
            self.m_in_bytes.inc(len(data), (ins.display_name,))
            events = self._run_filters(events, tag)
        finally:
            self._ingest_src = prev_src
        if not events:
            return 0
        if sp_on and sp.tasks:
            # flb_sp_do on the filtered records, never on the SP's own
            # emitted rows (a task whose pattern matches its output tag
            # must not feed itself). A task that raises is logged and the
            # append's records are kept, as in the reference; ``do`` runs
            # host Python only, and the rows it emitted re-enter the
            # chain after the handler, so a kernel's error there still
            # raises
            sp.hold()
            try:
                sp.do(events, tag)
            except DEVICE_ERRORS as exc:
                self._count_device_error(exc, "flux")
                raise
            except Exception:
                log.exception("stream processor failed")
            finally:
                sp.release()
        if cond_routing:
            self._append_split(ins, tag, events)
            return len(events)
        parts = [ev.raw if ev.raw is not None else reencode_event(ev)
                 for ev in events]
        payload = b"".join(parts)
        with ins.ingest_lock:
            chunk = ins.pool.append(tag, payload, len(events))
            if self.storage is not None:
                # the record ends come free from the parts
                self._persist(ins, chunk, payload, list(
                    itertools.accumulate(len(p) for p in parts)))
        return len(events)

    def _persist(self, ins: InputInstance, chunk: Chunk, data,
                 offsets=None) -> None:
        """Write an append through to its chunk's file when the input
        keeps filesystem storage (reference :1415-1427; with no qos
        plane, storage admits every append). ``offsets``: the append's
        record END offsets, when the caller has them."""
        if self.storage is not None and ins.storage_type == "filesystem":
            self.storage.write_through(chunk, data, offsets=offsets)

    def _append_split(self, ins: InputInstance, tag: str,
                      events: List[LogEvent]) -> None:
        """Conditional routing (reference :1192-1245,
        split_and_append_route_payloads, src/flb_input_log.c:1495): each
        record goes to the chunk of the outputs that admit it, a bit an
        output; the chunk carries that mask and the outputs' names. An
        output that matches the tag with no condition admits every
        record; a record no output admits is not appended."""
        outputs = self.outputs
        candidates = [(1 << i, o.route_condition)
                      for i, o in enumerate(outputs) if o.route.matches(tag)]
        groups: Dict[int, list] = {}
        for ev in events:
            mask = 0
            for bit, cond in candidates:
                if cond is None or cond.eval(ev.body):
                    mask |= bit
            if mask:
                groups.setdefault(mask, []).append(
                    ev.raw if ev.raw is not None else reencode_event(ev))
        with ins.ingest_lock:
            for mask, parts in groups.items():
                payload = b"".join(parts)
                chunk = ins.pool.append(tag, payload, len(parts),
                                        routes_mask=mask)
                if chunk.route_names is None:
                    chunk.route_names = tuple(
                        o.display_name for i, o in enumerate(outputs)
                        if (mask >> i) & 1)
                if self.storage is not None:
                    # persisted with its route names, not its mask bits
                    self._persist(ins, chunk, payload, list(
                        itertools.accumulate(len(p) for p in parts)))

    def _ingest_raw(self, ins: InputInstance, tag: str, data: bytes,
                    matching: List[FilterInstance],
                    n_records: Optional[int]):
        """The raw chain (the reference's ``_ingest_raw``, :1312-1405):
        per filter, ``process_batch`` first, then ``filter_raw`` if the
        hook declined; the bytes one filter keeps and the record count
        it finds are the next one's input. Returns the records written;
        None when a filter declines before any ``stateful_batch`` hook
        ran, or the bytes cannot be counted (the decoded path re-runs
        the whole chain); or a ``_RawTail`` when one declines after such
        a hook. ``committed`` is set before a stateful hook is called:
        its effects are out once it has run. A hook or raw filter that
        raises is logged and declines (reference :1366-1368); a device
        error raises."""
        in_bytes = len(data)
        n = n_records
        chunk = RawChunk(data, tag, n, src=ins, engine=self)
        deltas: list = []  # (filter, records in, records out)
        committed = False
        for fi, f in enumerate(matching):
            plugin = f.plugin
            prev = data
            got = None
            try:
                if plugin.can_process_batch():
                    if chunk.data is not data:
                        chunk.replace(data, n)
                    else:
                        chunk.n = n
                    if plugin.stateful_batch:
                        committed = True
                    t0 = time.perf_counter()
                    got = plugin.process_batch(chunk)
                    if got is not None:
                        f.note_batch(time.perf_counter() - t0)
                if got is None and plugin.can_filter_raw():
                    got = plugin.filter_raw(data, tag, self, n_records=n)
            except DEVICE_ERRORS as exc:
                self._count_device_error(exc, _lane_of(plugin))
                raise
            except Exception:
                log.exception("filter %s raw path failed", f.display_name)
                got = None
            if got is None:
                self.m_filter_batch_decline.inc(1, (f.display_name,))
                if not committed:
                    return None  # the decoded path re-runs the chain
                return _RawTail(tag, data, matching[fi:], n, n_records,
                                deltas, in_bytes)
            if len(got) == 3:
                n2, data, n_in = got
                if n is None:
                    n = n_in
            else:
                n2, data = got
                if n is None:  # the hook did not count: count its input
                    n = fast_count_records(prev)
                    if n is None:
                        if not committed:
                            return None
                        # the input count cannot be found and a decoded
                        # re-run would repeat committed effects: skip
                        # this filter's add/drop delta
                        log.warning(
                            "filter %s output uncountable after a "
                            "committed batch stage; its filter metrics "
                            "delta is skipped", f.display_name)
                        n = n2
            deltas.append((f.display_name, n, n2))
            n = n2
            if n == 0:
                break
        if n is None:  # no filter matched: count the records natively
            n = fast_count_records(data)
            if n is None:
                return None
        return self._finish_raw_append(ins, tag, data, n, n_records,
                                       deltas, in_bytes)

    def _finish_raw_append(self, ins: InputInstance, tag: str, data, n: int,
                           n_records: Optional[int], deltas: list,
                           in_bytes: int) -> int:
        """The raw path's commit (reference :1421-1447): the filters'
        add/drop deltas, the input's counts, the pool append."""
        if n_records is None:
            n_records = deltas[0][1] if deltas else n
        for name, before, after in deltas:
            if after < before:
                self.m_filter_drop.inc(before - after, (name,))
            elif after > before:
                self.m_filter_add.inc(after - before, (name,))
        self.m_in_records.inc(n_records, (ins.display_name,))
        self.m_in_bytes.inc(in_bytes, (ins.display_name,))
        if n == 0:
            return 0
        if not isinstance(data, bytes):
            data = bytes(data)
        with ins.ingest_lock:  # re-entered on the parallel path
            chunk = ins.pool.append(tag, data, n)
            # the record ends from the host codec's offset scan
            self._persist(ins, chunk, data)
        return n

    def _finish_raw_tail(self, ins: InputInstance, cont: _RawTail):
        """Finish a ``_RawTail`` (reference :1450): the remaining filters
        on the decoded records, then the raw path's commit. Called with
        no raw-path lock held. When the bytes do not decode, they are
        appended as they are; None when they cannot even be counted (the
        decoded path then takes the append)."""
        tail = self._raw_tail_decoded(cont.data, cont.tag, cont.remaining,
                                      ins)
        n, data, n_records = cont.n, cont.data, cont.n_records
        if tail is not None:
            n, data, n_in = tail
            if n_records is None and not cont.deltas:
                # the first filter declined before any count was found:
                # the tail's decode is the append's input count
                n_records = n_in
            # the tail's own add/drop counts were made by _run_filters
        elif n is None:
            n = fast_count_records(data)
            if n is None:
                return None
        return self._finish_raw_append(ins, cont.tag, data, n, n_records,
                                       cont.deltas, cont.in_bytes)

    def _raw_tail_decoded(self, data, tag: str,
                          remaining: List[FilterInstance],
                          ins: InputInstance) -> Optional[tuple]:
        """The decoded path's filter code over the remaining filters only
        (reference :1479), with ``_ingest_src`` at the appending input so
        the own-emitter guards fire as on the decoded path. Returns
        ``(n_out, data_out, n_in)``, or None when the bytes do not
        decode (a filter broke its contract: the caller appends them as
        they are, reference :1467-1473)."""
        try:
            events = decode_events(bytes(data))
        except DEVICE_ERRORS:
            raise  # the codec extension's build failed
        except Exception:
            log.exception("raw-chain tail decode failed; remaining "
                          "filters skipped for this append")
            return None
        n_in = len(events)
        with self._ingest_lock:
            prev_src, self._ingest_src = self._ingest_src, ins
            try:
                events = self._run_filters(events, tag, filters=remaining)
            finally:
                self._ingest_src = prev_src
        out = b"".join(ev.raw if ev.raw is not None else reencode_event(ev)
                       for ev in events)
        return len(events), out, n_in

    def input_event_append(self, ins: InputInstance, tag: Optional[str],
                           data: bytes, event_type: str,
                           n_records: int = 1) -> int:
        """Typed append (metrics snapshots): no filter chain (reference
        typed appends, src/flb_input_metric.c). Returns the records
        written."""
        tag = tag or ins.tag or ins.plugin.name
        with self._ingest_lock:
            with ins.ingest_lock:
                self.m_in_records.inc(n_records, (ins.display_name,))
                self.m_in_bytes.inc(len(data), (ins.display_name,))
                chunk = ins.pool.append(tag, data, n_records, event_type)
                self._persist(ins, chunk, data)
        return n_records

    def _run_filters(self, events: List[LogEvent], tag: str,
                     filters: Optional[List[FilterInstance]] = None
                     ) -> List[LogEvent]:
        """flb_filter_do equivalent (src/flb_filter.c:119-330), counting
        each filter's added and dropped records (reference :1578-1617).
        ``filters`` restricts the pass to a sub-chain (the raw path's
        decoded tail). A filter that raises is logged and its input
        passes on (reference :1594-1598); a device error raises."""
        for f in (self.filters if filters is None else filters):
            if not events:
                break
            if not f.route.matches(tag):
                continue
            before = len(events)
            try:
                result, new_events = f.plugin.filter(events, tag, self)
            except DEVICE_ERRORS as exc:
                self._count_device_error(exc, _lane_of(f.plugin))
                raise
            except Exception:
                log.exception("filter %s failed", f.display_name)
                continue
            if result == FilterResult.MODIFIED:
                events = new_events if new_events is not None else []
                after = len(events)
                if after > before:
                    self.m_filter_add.inc(after - before, (f.display_name,))
                elif after < before:
                    self.m_filter_drop.inc(before - after,
                                           (f.display_name,))
        return events

    # ------------------------------------------------------------------
    # dispatch + flush (reference: flb_engine_flush → flb_engine_dispatch)
    # ------------------------------------------------------------------

    def flush_all(self) -> None:
        """Drain ready chunks into tasks and start their route flushes:
        the backlog first, then each input's pool in order (the order
        the reference's fair queue pops under its one default tenant,
        fluentbit_tpu/core/qos.py:467-500). When the task map is full,
        that chunk and the rest of the cycle park on the backlog
        (reference :1624-1730). While the engine runs, only its loop
        thread calls this (the timer, the stop drain, ``flush_now``).
        The guard's watchdog rides it (``housekeeping``); the failpoint
        site ``engine.flush_dispatch`` fires between the drain and the
        tasks, and an injected failure parks the cycle's chunks on the
        backlog (a panic raises). A filesystem input's drained chunks are
        finalized (their CRC stamped), and a paused input resumes once
        its pool is under its limits (reference :1638-1670)."""
        if self.started_at:
            self.m_uptime.set(time.time() - self.started_at)
        self.guard.housekeeping()
        with self._ingest_lock:
            chunks, self._backlog = self._backlog, []
            for ins in self.inputs:
                with ins.ingest_lock:  # parallel raw appends
                    drained = ins.pool.drain()
                if self.storage is not None \
                        and ins.storage_type == "filesystem":
                    for chunk in drained:
                        self.storage.finalize(chunk)
                chunks.extend(drained)
                if ins.paused:
                    with ins.ingest_lock:
                        drained_ok = (
                            not ins.mem_buf_limit
                            or ins.pool.pending_bytes < ins.mem_buf_limit
                        ) and (
                            not ins.pause_on_chunks_overlimit
                            or ins.pool.pending_chunks
                            < self.service.storage_max_chunks_up)
                    if drained_ok:
                        ins.set_paused(False)
        if _fp.ACTIVE and chunks:
            try:
                _fp.fire("engine.flush_dispatch")
            except _fp.FailpointError:
                log.warning("flush dispatch failed (injected); %d "
                            "chunk(s) re-queued", len(chunks))
                with self._ingest_lock:
                    self._backlog.extend(chunks)
                return
        for i, chunk in enumerate(chunks):
            if not self._dispatch_chunk(chunk):
                with self._ingest_lock:
                    self._backlog.extend(chunks[i:])
                break

    def _dispatch_chunk(self, chunk: Chunk) -> bool:
        """Resolve a chunk's routes (by ``route_names``, else by
        ``routes_mask``, else by tag) and give it a task in the map
        (reference :1762-1839). Returns False only when the map is full
        (the chunk must park); a chunk no output takes is done, and so is
        one the guard sheds (every route behind an open breaker, the map
        at the watermark)."""
        outputs = self.outputs
        if chunk.route_names is not None:
            routes = [o for o in outputs
                      if o.display_name in chunk.route_names
                      and chunk.event_type in o.plugin.event_types]
        elif chunk.routes_mask:
            routes = [o for i, o in enumerate(outputs)
                      if (chunk.routes_mask >> i) & 1
                      and chunk.event_type in o.plugin.event_types]
        else:
            routes = [o for o in outputs
                      if o.route.matches(chunk.tag)
                      and chunk.event_type in o.plugin.event_types]
        if not routes:
            if self.storage is not None:
                self.storage.delete(chunk)
            return True
        if self.guard.maybe_shed(chunk, routes):
            return True
        with self._task_lock:
            if len(self._task_map) >= self.service.task_map_size:
                now = time.time()
                if now - self._task_map_warned > 5.0:
                    self._task_map_warned = now
                    log.warning("task map full (%d tasks in flight): "
                                "chunk dispatch paused until slots free",
                                len(self._task_map))
                return False
            # every route counted before the first spawn: a route that
            # completes inline must not free the slot under its siblings
            task = Task(chunk, len(routes))
            self._task_map[task.id] = task
        for out in routes:
            self._spawn_flush(task, out)
        return True

    def _task_unref(self, task: Task) -> bool:
        """flb_task_users_dec: the last route to finish frees the slot.
        Returns True for the last route (the chunk's file may go)."""
        with self._task_lock:
            task.users -= 1
            done = task.users == 0
            if done:
                self._task_map.pop(task.id, None)
        return done

    def _enqueue_event(self, priority: int, fn) -> None:
        """Queue a ready callback in the bucket queue and wake the loop
        to drain it (flb_engine_handle_event's demux order)."""
        with self._event_queue_lock:
            self._event_queue.add(priority, fn)
        self.loop.call_soon_threadsafe(self._drain_event_queue)

    def _drain_event_queue(self) -> None:
        while True:
            with self._event_queue_lock:
                if not self._event_queue:
                    return
                fn = self._event_queue.pop()
            try:
                fn()
            except Exception:
                log.exception("engine event callback failed")

    def _spawn_flush(self, task: Task, out: OutputInstance,
                     priority: Optional[int] = None) -> None:
        """Start one route's flush on the loop, at ``priority`` (flush
        by default; a retry's fire comes at the top). While the output's
        breaker is open, a retry is scheduled instead, not counted
        against ``retry_limit`` (reference :1877-1895). With the engine
        not running, the flush runs here, its retries too."""
        if self.loop is not None and self.running:
            delay = self.guard.short_circuit_delay(out)
            if delay is not None:
                self.guard.m_short_circuit.inc(1, (out.display_name,))
                self._schedule_retry(task, out, delay)
                return
        coro = self._flush_one(task, out)
        if self.loop is None or not self.running:
            asyncio.run(coro)
            return

        def _create():
            fut = asyncio.ensure_future(coro)
            self.guard.track(task, out, fut)
            self._pending_flushes.add(fut)
            fut.add_done_callback(self._pending_flushes.discard)

        try:
            self._enqueue_event(
                PRIORITY_FLUSH if priority is None else priority, _create)
        except RuntimeError:  # loop closed mid-stop: the route drops
            coro.close()
            self.m_out_errors.inc(1, (out.display_name,))
            self.m_out_dropped.inc(task.chunk.records, (out.display_name,))
            self._task_unref(task)

    async def _flush_one(self, task: Task, out: OutputInstance) -> None:
        """One (task × output) flush attempt. A RETRY does not wait
        here: it arms a loop timer that spawns a new attempt
        (``_schedule_retry``), so a chunk in backoff holds no coroutine
        and no slot of the output's flush semaphore. With the engine not
        running the retries wait inline. A flush the guard soft-killed
        past its deadline is a RETRY (reference :1914-1932); any other
        cancel (the stop) propagates."""
        try:
            delay = await self._flush_body(task, out)
        except asyncio.CancelledError:
            if not self.guard.consume_timeout(task, out):
                # the stop, with this route undelivered: a memory chunk
                # goes to the DLQ; a filesystem one is on disk already
                # and is the next start's backlog (reference :1933-1944)
                self._quarantine_at_stop(task.chunk, "shutdown quarantine")
                raise
            delay = self._handle_flush_result(task, out, FlushResult.RETRY)
        if delay is None:
            return
        if self.loop is not None and self.running:
            self._schedule_retry(task, out, delay)
            return
        while delay is not None:
            await asyncio.sleep(delay)
            delay = await self._flush_body(task, out)

    async def _flush_body(self, task: Task, out: OutputInstance
                          ) -> Optional[float]:
        """The attempt (reference :1976-2067): the output's flush slot
        (one for a synchronous or no_multiplex output, N for ``workers
        N``), then the test formatter, the worker pool or the plugin on
        this loop. The guard's deadline runs from the slot's acquire,
        and ``guard.CANCEL_EVENT`` holds the attempt's cancel flag; the
        async failpoint sites ``output.flush`` and
        ``output.flush.<output>`` fire before the plugin. A flush that
        raises is the output's ERROR. Returns the backoff delay of a
        retry, else None."""
        chunk = task.chunk
        data = chunk.get_bytes()
        sem = out.flush_semaphore
        if sem is not None:
            await sem.acquire()
        rec = self.guard.flight(task, out)
        if rec is not None:
            rec.started = time.time()
            rec.begun = True
            _guard.CANCEL_EVENT.set(rec.cancel_event)
        try:
            if out.test_formatter is not None:
                try:
                    out.test_formatter(data, chunk.tag)
                    result = FlushResult.OK
                except Exception:
                    log.exception("test formatter failed")
                    result = FlushResult.ERROR
            else:
                try:
                    if _fp.ACTIVE:
                        # async sites: a hang suspends this flush only,
                        # and the guard's deadline can cancel it
                        await _fp.fire_async("output.flush")
                        await _fp.fire_async(
                            "output.flush." + out.display_name)
                    if out.worker_pool is not None:
                        if rec is not None:
                            rec.worker = True
                        result = await out.worker_pool.submit(
                            self._worker_flush(out.plugin, data,
                                               chunk.tag, rec))
                    else:
                        result = await out.plugin.flush(data, chunk.tag,
                                                        self)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception("output %s flush raised",
                                  out.display_name)
                    result = FlushResult.ERROR
        finally:
            if sem is not None:
                sem.release()
        return self._handle_flush_result(task, out, result)

    async def _worker_flush(self, plugin, data: bytes, tag: str, rec):
        """The plugin's flush on a worker's loop, with the attempt's
        cancel flag in ``guard.CANCEL_EVENT`` there too (a context
        variable does not cross ``run_coroutine_threadsafe``) and its
        end marked, so the watchdog tells a soft-kill that landed late
        from a thread wedged in sync code."""
        if rec is not None:
            _guard.CANCEL_EVENT.set(rec.cancel_event)
        try:
            return await plugin.flush(data, tag, self)
        finally:
            if rec is not None:
                rec.worker_done = True

    def _schedule_retry(self, task: Task, out: OutputInstance,
                        delay: float) -> None:
        """Arm the retry's timer (flb_sched_request_create →
        flb_engine_dispatch_retry; reference :2088-2132): it fires at
        the top priority. Once the engine is stopping, the retry drops
        instead; ``_main`` drops those still pending after the grace
        wait. An injected failure of the site ``engine.retry_schedule``
        drops the retry as the stop does."""
        key = (task.chunk.id, out.name)
        if _fp.ACTIVE:
            try:
                _fp.fire("engine.retry_schedule")
            except _fp.FailpointError:
                log.warning("retry scheduling failed (injected); "
                            "dropping retry for %s", out.display_name)
                self._drop_retry(task, out)
                return

        def _fire():
            self._pending_retries.pop(key, None)
            self._spawn_flush(task, out, priority=PRIORITY_TOP)

        def _register():
            if self._stopping:
                self._drop_retry(task, out)
                return
            handle = self.loop.call_later(delay, _fire)
            self._pending_retries[key] = (task, out, handle)

        try:
            self.loop.call_soon_threadsafe(_register)
        except RuntimeError:
            self._drop_retry(task, out)

    def _drop_retry(self, task: Task, out: OutputInstance) -> None:
        """Count a retry dropped at stop like every other drop, and
        quarantine its chunk unless its bytes are on disk already
        (reference :2135-2147)."""
        self.m_out_errors.inc(1, (out.display_name,))
        self.m_out_dropped.inc(task.chunk.records, (out.display_name,))
        self._quarantine_at_stop(task.chunk, "retry quarantine")
        self._task_unref(task)

    def _quarantine_at_stop(self, chunk: Chunk, what: str) -> None:
        """The DLQ for an undelivered memory chunk at stop; the failpoint
        site ``engine.shutdown_quarantine`` fires first. A failure is
        logged."""
        if self.storage is None or self.storage.is_tracked(chunk):
            return
        try:
            if _fp.ACTIVE:
                _fp.fire("engine.shutdown_quarantine")
            self.storage.quarantine(chunk)
        except Exception:
            log.exception("%s failed", what)

    def _handle_flush_result(self, task: Task, out: OutputInstance,
                             result) -> Optional[float]:
        """handle_output_event (src/flb_engine.c:302-540; reference
        :2150-2187): OK counts the delivery; RETRY returns the backoff
        while the attempts stay within the output's ``retry_limit`` (the
        service's when unset; -1 has no limit); ERROR, or a RETRY past
        the limit, drops the chunk for this output and counts it. Every
        outcome feeds the output's breaker (reference :2157-2177). With
        storage, a dropped chunk is quarantined into the DLQ, and the
        chunk's file is deleted when its last route is done."""
        name = out.display_name
        chunk = task.chunk
        if result == FlushResult.OK:
            self.guard.on_result(out, ok=True)
            self.m_out_proc_records.inc(chunk.records, (name,))
            self.m_out_proc_bytes.inc(chunk.size, (name,))
            self.m_latency.observe(time.time() - chunk.created, (name,))
            if self._task_unref(task) and self.storage is not None:
                self.storage.delete(chunk)  # every route delivered
            return None
        if result == FlushResult.RETRY:
            attempts = task.retries.get(out.name, 0) + 1
            task.retries[out.name] = attempts
            limit = out.retry_limit if out.retry_limit is not None \
                else self.service.retry_limit
            if limit == -1 or attempts <= limit:
                self.guard.on_result(out, ok=False)
                self.m_out_retries.inc(1, (name,))
                return backoff_full_jitter(self.service.scheduler_base,
                                           self.service.scheduler_cap,
                                           attempts)
            self.m_out_retries_failed.inc(1, (name,))
        self.guard.on_result(out, ok=False)
        log.warning("output %s: flush returned %s, %d records dropped",
                    name, getattr(result, "name", result), chunk.records)
        self.m_out_errors.inc(1, (name,))
        self.m_out_dropped.inc(chunk.records, (name,))
        if self.storage is not None:
            try:
                self.storage.quarantine(chunk)
            except Exception:
                log.exception("DLQ quarantine failed")
        if self._task_unref(task) and self.storage is not None:
            self.storage.delete(chunk)  # the DLQ copy is its own file
        return None

    def flush_now(self) -> None:
        """Force a flush cycle and wait until its tasks settle: delivered
        or dropped, retries included (at most 5 s)."""
        if self.loop is None or not self.running:
            self.flush_all()
            return
        # the cycle runs on the loop thread, in order with the timer's,
        # and spawns its flushes before the wait below begins
        settled = threading.Event()

        def _cycle():
            try:
                self.flush_all()
                self._drain_event_queue()
            finally:
                settled.set()

        try:
            self.loop.call_soon_threadsafe(_cycle)
        except RuntimeError:
            return
        settled.wait(timeout=5)
        deadline = time.time() + 5
        while self._task_map and time.time() < deadline:
            time.sleep(0.01)
