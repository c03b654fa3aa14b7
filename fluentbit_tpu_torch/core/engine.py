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
instead. Storage, qos, guard, failpoints, the admin HTTP server,
multiline, retries, the raw path's batch hooks (``process_batch``) and
its per-input parallel lock wait for later slices.

Reference: src/flb_engine.c (flb_engine_start event loop),
src/flb_engine_dispatch.c (chunk → per-route flush), src/flb_input_chunk.c
(ingest + synchronous filter chain at append, :3078). The engine is a
host-side asyncio loop in its own thread; the filter chain runs
synchronously in the appending thread. Device work happens inside filters
on ``engine.device``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..codec.chunk import Chunk
from ..codec.events import (LogEvent, decode_events, fast_count_records,
                            reencode_event)
from .chunk_batch import RawChunk
from .config import ServiceConfig
from .metrics import MetricsRegistry
from .plugin import (
    FilterInstance,
    FilterResult,
    FlushResult,
    InputInstance,
    OutputInstance,
    registry as default_registry,
)

log = logging.getLogger("flb.engine")


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
        self.metrics = MetricsRegistry()
        self.parsers: Dict[str, Any] = {}  # named parsers (flb_parser registry)
        self._ingest_src: Optional[InputInstance] = None  # under the lock
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stopping = False
        # serializes ingest (filters + pool appends) against pool drains;
        # reentrant because a filter may append from inside the chain
        # (log_to_metrics emits its snapshot through input_event_append)
        self._ingest_lock = threading.RLock()
        self._start_error: Optional[BaseException] = None
        self._pending_flushes: set = set()
        self.sp = None  # the stream processor, made by the first sp_task

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------

    def _make_instance(self, create, name: str, props, peers):
        ins = create(name)
        n = sum(1 for p in peers if p.plugin.name == ins.plugin.name)
        ins.name = f"{ins.plugin.name}.{n}"
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
        ``attach_flux`` raises, so does this call (the reference package
        logs and keeps the exact path)."""
        from ..stream_processor import StreamProcessor

        if self.sp is None:
            self.sp = StreamProcessor(self)
        task = self.sp.create_task(sql)
        if allow_flux and os.environ.get(
                "FBTPU_FLUX_SQL", "on").lower() not in ("0", "off"):
            from ..flux.query import attach_flux

            try:
                attach_flux(self, task)
            except Exception:
                self.sp.tasks.remove(task)
                raise
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
        """Init every instance, then spawn the engine thread (flb_start)."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        for ins in self.inputs + self.filters + self.outputs:
            if getattr(ins, "_initialized", False):
                continue  # hidden instances are initialized at creation
            ins.configure()
            ins.plugin.init(ins, self)
        self._stopping = False
        self._start_error = None
        self._thread = threading.Thread(target=self._run, name="flb-engine",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("engine failed to start")
        if self._start_error is not None:
            self._thread.join(timeout=10)
            self._thread = None
            raise RuntimeError("engine failed to start") from self._start_error

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
            # graceful drain (grace period, src/flb_engine.c:1137-1160)
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
        finally:
            self._stopping = True
            pending = [ins.collector_task for ins in self.inputs
                       if ins.collector_task is not None]
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            self._started.clear()

    async def _collector(self, ins: InputInstance) -> None:
        """Interval collector (flb_input_set_collector_time)."""
        while True:
            try:
                ins.plugin.collect(self)
            except Exception:
                log.exception("input %s collect failed", ins.display_name)
            await asyncio.sleep(ins.plugin.collect_interval)

    def stop(self) -> None:
        """Graceful stop with drain (flb_stop)."""
        if self._thread is None:
            return
        self._stopping = True
        self._thread.join(timeout=self.service.grace + 10)
        if self._thread.is_alive():
            log.warning("engine thread did not exit within %.1fs at stop()",
                        self.service.grace + 10)
        self._thread = None
        try:
            if self.sp is not None and self.sp.tasks:
                # the open SQL windows: their rows go through the chain
                # and are flushed here, the engine thread having ended
                with self._ingest_lock:
                    self.sp.drain()
                self.flush_all()
        finally:
            for ins in self.inputs + self.filters + self.outputs:
                try:
                    ins.plugin.exit()
                except Exception:
                    log.exception("%s exit failed", ins.display_name)

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
        input's chunk pool. Returns the records written.

        When every filter whose route matches the tag ``can_filter_raw``
        and no exact stream-processor task matches it (the reference's
        ``raw_ok`` gate, fluentbit_tpu/core/engine.py:1069-1122, with no
        processors, conditional routing or trace in the port), the chain
        runs on the raw bytes. A filter that declines (returns None)
        sends the append down the decoded path: decode, filter chain, the
        stream processor on the kept events, re-encode of modified
        events. A flux-backed SQL task does not force the decoded path:
        its hidden flux filter absorbs inside the chain.

        A filter that raises fails the append: no path has a silent
        pass-through (the reference package logs and continues). A
        stream-processor task that raises is logged and the append's
        records are kept, as in the reference (an SQL task's error is
        host Python, never a device failure)."""
        tag = tag or ins.tag or ins.plugin.name
        matching = [f for f in self.filters if f.route.matches(tag)]
        sp = self.sp
        sp_on = sp is not None and ins is not sp.emitter_instance
        sp_active = sp_on and any(t.matches(tag) and t.flux is None
                                  for t in sp.tasks)
        with self._ingest_lock:
            # saved and restored: an emitter re-enters this method from
            # inside the chain, and the outer chain's remaining filters
            # must see the outer append's source again
            prev_src, self._ingest_src = self._ingest_src, ins
            try:
                if not sp_active and all(f.plugin.can_filter_raw()
                                         for f in matching):
                    got = self._ingest_raw(ins, tag, data, matching,
                                           n_records)
                    if got is not None:
                        return got
                events = self._run_filters(decode_events(data), tag)
            finally:
                self._ingest_src = prev_src
            if not events:
                return 0
            if sp_on and sp.tasks:
                # flb_sp_do on the filtered records, never on the SP's
                # own emitted rows (a task whose pattern matches its
                # output tag must not feed itself). A task that raises
                # is logged and the append's records are kept, as in the
                # reference; ``do`` runs host Python only, and the rows
                # it emitted re-enter the chain after the handler, so a
                # kernel's error there still raises
                sp.hold()
                try:
                    sp.do(events, tag)
                except Exception:
                    log.exception("stream processor failed")
                finally:
                    sp.release()
            payload = b"".join(
                ev.raw if ev.raw is not None else reencode_event(ev)
                for ev in events)
            ins.pool.append(tag, payload, len(events))
            return len(events)

    def _ingest_raw(self, ins: InputInstance, tag: str, data: bytes,
                    matching: List[FilterInstance],
                    n_records: Optional[int]) -> Optional[int]:
        """The raw chain (the reference's ``_ingest_raw``, :1312): each
        filter's ``filter_raw`` takes the bytes the previous one kept,
        the record count found by one is the next one's hint, and the
        survivors go to the pool as they are. Returns the records
        written, or None when a filter declines or the bytes cannot be
        counted: grep filters commit nothing, so the decoded path then
        re-runs the whole chain from the input bytes."""
        chunk = RawChunk(data, tag, n_records, src=ins, engine=self)
        for f in matching:
            got = f.plugin.filter_raw(chunk.data, tag, self,
                                      n_records=chunk.n)
            if got is None:
                return None
            n_kept, out, _n_in = got
            chunk.replace(out, n_kept)
            if n_kept == 0:
                return 0
        n = chunk.n
        if n is None:  # no filter matched: count the records natively
            n = fast_count_records(chunk.data)
            if n is None:
                return None
        if n == 0:
            return 0
        ins.pool.append(tag, chunk.as_bytes(), n)
        return n

    def input_event_append(self, ins: InputInstance, tag: Optional[str],
                           data: bytes, event_type: str,
                           n_records: int = 1) -> int:
        """Typed append (metrics snapshots): no filter chain (reference
        typed appends, src/flb_input_metric.c). Returns the records
        written."""
        tag = tag or ins.tag or ins.plugin.name
        with self._ingest_lock:
            ins.pool.append(tag, data, n_records, event_type)
        return n_records

    def _run_filters(self, events: List[LogEvent], tag: str) -> List[LogEvent]:
        """flb_filter_do equivalent (src/flb_filter.c:119-330)."""
        for f in self.filters:
            if not events:
                break
            if not f.route.matches(tag):
                continue
            result, new_events = f.plugin.filter(events, tag, self)
            if result == FilterResult.MODIFIED:
                events = new_events if new_events is not None else []
        return events

    # ------------------------------------------------------------------
    # dispatch + flush (reference: flb_engine_flush → flb_engine_dispatch)
    # ------------------------------------------------------------------

    def flush_all(self) -> None:
        """Drain ready chunks and start one flush per (chunk, route).
        While the engine runs, only its loop thread calls this (the timer,
        the stop drain, ``flush_now``), so chunks reach each output in
        the order they were drained."""
        with self._ingest_lock:
            chunks = [chunk for ins in self.inputs for chunk in ins.pool.drain()]
        for chunk in chunks:
            for out in self.outputs:
                if (out.route.matches(chunk.tag)
                        and chunk.event_type in out.plugin.event_types):
                    self._spawn_flush(chunk, out)

    def _spawn_flush(self, chunk: Chunk, out: OutputInstance) -> None:
        coro = self._flush_one(chunk, out)
        if self.loop is None or not self.running:
            asyncio.run(coro)  # engine not started: flush inline
            return

        def _create():
            fut = asyncio.ensure_future(coro)
            self._pending_flushes.add(fut)
            fut.add_done_callback(self._pending_flushes.discard)

        try:
            self.loop.call_soon_threadsafe(_create)
        except RuntimeError:  # loop closed mid-stop
            coro.close()
            log.error("output %s: engine stopped, %d records dropped",
                      out.display_name, chunk.records)

    async def _flush_one(self, chunk: Chunk, out: OutputInstance) -> None:
        try:
            result = await out.plugin.flush(chunk.get_bytes(), chunk.tag, self)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("output %s flush raised", out.display_name)
            result = FlushResult.ERROR
        if result != FlushResult.OK:
            # no retry scheduler in this slice: a non-OK flush drops
            log.error("output %s: flush returned %s, %d records dropped",
                      out.display_name, result.name, chunk.records)

    def flush_now(self) -> None:
        """Force a flush cycle and wait for pending flushes to settle."""
        if self.loop is None or not self.running:
            self.flush_all()
            return
        # the cycle runs on the loop thread, in order with the timer's;
        # call_soon_threadsafe callbacks run FIFO, so once the sentinel
        # fires every flush the cycle spawned is in _pending_flushes
        settled = threading.Event()
        try:
            self.loop.call_soon_threadsafe(self.flush_all)
            self.loop.call_soon_threadsafe(settled.set)
        except RuntimeError:
            return
        settled.wait(timeout=5)
        deadline = time.time() + 5
        while self._pending_flushes and time.time() < deadline:
            time.sleep(0.01)
