"""Plugin model — vtables, instances, registry.

The port's own copy of ``fluentbit_tpu/core/plugin.py``, trimmed to the
input, filter and output kinds of this slice. The port keeps its own
registry: its plugins never register into the reference package's.

Reference: the C plugin vtables flb_input_plugin / flb_filter_plugin /
flb_output_plugin (include/fluent-bit/flb_input.h, flb_filter.h,
flb_output.h) with cb_init/cb_collect/cb_filter/cb_flush/cb_exit, and the
per-instance property machinery in src/flb_input.c / flb_output.c /
flb_filter.c.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Type

from .config import (OUTPUT_INSTANCE_KEYS, ConfigMapEntry, Properties,
                     apply_config_map, parse_bool, parse_size, parse_time)
from .router import Route
from ..codec.chunk import ChunkPool, EVENT_TYPE_LOGS

log = logging.getLogger("flb.plugin")


class FlushResult(enum.Enum):
    """Output flush verdicts (reference FLB_OK/FLB_RETRY/FLB_ERROR)."""

    OK = 1
    RETRY = 2
    ERROR = 3


class FilterResult(enum.Enum):
    """Filter verdicts (FLB_FILTER_NOTOUCH / FLB_FILTER_MODIFIED)."""

    NOTOUCH = 1
    MODIFIED = 2


class Plugin:
    """Common plugin base."""

    name: str = ""
    description: str = ""
    config_map: List[ConfigMapEntry] = []
    # event types the plugin handles; logs only in this slice
    event_types = (EVENT_TYPE_LOGS,)

    def __init__(self) -> None:
        self.instance: Optional["Instance"] = None

    def init(self, instance: "Instance", engine) -> None:  # cb_init
        pass

    def exit(self) -> None:  # cb_exit
        pass


class InputPlugin(Plugin):
    """Input vtable. Interval collectors declare ``collect_interval``
    (seconds) and implement ``collect(engine)``
    (flb_input_set_collector_time); library inputs expose ``push``.
    ``pause`` / ``resume`` are the backpressure callbacks (cb_pause,
    cb_resume): the engine calls them when the input's buffer crosses
    its limit and when it drains."""

    default_tag: Optional[str] = None
    collect_interval: Optional[float] = None

    def collect(self, engine) -> None:
        pass

    def pause(self) -> None:
        pass

    def resume(self) -> None:
        pass


class FilterPlugin(Plugin):
    """Filter vtable: ``filter(events, tag, engine) -> (FilterResult,
    events')`` over the decoded events of one append. Untouched records
    keep their raw spans, so the chunk writer re-emits them verbatim.

    The raw chunk path takes a filter that has either of two hooks (the
    engine asks ``can_filter_raw() or can_process_batch()`` per append):

    - ``process_batch(chunk)`` over a :class:`~.chunk_batch.RawChunk`
      (reference ``FilterPlugin.process_batch``): returns
      ``(n_out, data')``, ``(n_out, data', n_in)`` when the hook found
      the input's record count, or None to decline;
    - ``filter_raw(data, tag, engine, n_records) -> (n_kept, data',
      n_records) | None`` (grep's staged device match).

    The engine calls ``process_batch`` first, then ``filter_raw`` if the
    batch hook declined. A decline sends the append to the decoded path:
    the whole chain re-runs when no ``stateful_batch`` hook has run yet,
    else the remaining filters finish on the decoded records. A hook that
    raises fails the append.

    ``thread_safe_raw``: the hook keeps no state across appends, so a
    chain of such filters (none ``stateful_batch``) runs under the
    input's own lock and inputs append in parallel. ``stateful_batch``:
    the hook commits side effects (emits, counters, sketch state), so a
    decline after it must not re-run it."""

    thread_safe_raw: bool = False
    stateful_batch: bool = False

    def filter(self, events: list, tag: str, engine) -> tuple:
        return (FilterResult.NOTOUCH, events)

    def can_process_batch(self) -> bool:
        return False

    def process_batch(self, chunk) -> Optional[tuple]:
        return None

    def can_filter_raw(self) -> bool:
        return False


class OutputPlugin(Plugin):
    """Output vtable: async ``flush(chunk_bytes, tag, engine) -> FlushResult``.

    ``synchronous`` (FLB_OUTPUT_SYNCHRONOUS) and ``no_multiplex``
    (FLB_OUTPUT_NO_MULTIPLEX): one flush in flight at a time; a
    synchronous plugin also gets no worker threads. A plugin may define
    ``worker_init(index)`` and ``worker_exit(index)``, which each of its
    worker threads runs."""

    synchronous: bool = False
    no_multiplex: bool = False

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        return FlushResult.OK


class Instance:
    """A configured plugin instance (flb_input_instance etc.)."""

    #: the engine's keys this kind of instance reads itself
    instance_keys = frozenset()

    def __init__(self, plugin: Plugin):
        self.plugin = plugin
        # provisional name; the engine re-numbers per context
        self.name = f"{plugin.name}.0"
        self.alias: Optional[str] = None
        self.properties = Properties()
        self.route = Route(match="*")
        plugin.instance = self

    def set(self, key: str, value: Any) -> None:
        self.properties.set(key, value)

    def configure(self) -> None:
        """Apply config_map + core keys."""
        apply_config_map(self.plugin.config_map, self.properties, self.plugin,
                         self.instance_keys)
        self.alias = self.properties.get("alias")
        match = self.properties.get("match")
        match_regex = self.properties.get("match_regex")
        if match or match_regex:
            self.route = Route(match=match, match_regex=match_regex)

    @property
    def display_name(self) -> str:
        return self.alias or self.name


class InputInstance(Instance):
    """An input, with its chunk pool and what backpressure and storage
    read of it (reference ``InputInstance``,
    fluentbit_tpu/core/plugin.py:203-269): ``mem_buf_limit`` (0: none),
    ``storage_type`` (memory, filesystem or memrb),
    ``pause_on_chunks_overlimit`` (pause at the service's
    ``storage.max_chunks_up`` chunks), ``threaded`` (the collector on a
    thread of its own) and the ``paused`` flag."""

    def __init__(self, plugin: InputPlugin):
        super().__init__(plugin)
        self.pool = ChunkPool()
        self.tag: Optional[str] = None
        self.mem_buf_limit = 0
        self.paused = False
        self.storage_type = "memory"
        self.pause_on_chunks_overlimit = False
        self.threaded = False
        self.collector_task = None
        self.collector_thread = None
        # serialises this input's pool: every append and drain of its
        # chunks holds it, so a raw chain of thread_safe_raw filters runs
        # without the engine's lock (reference: per-input chunk maps,
        # src/flb_input_log.c:1524). Reentrant: the engine-lock paths
        # take it around their pool touches. Order: Engine lock, then
        # this one.
        self.ingest_lock = threading.RLock()

    def set_paused(self, paused: bool) -> bool:
        """Flip the backpressure flag and call the plugin's ``pause`` or
        ``resume`` (src/flb_input.c:740-788), under the input's lock so
        two appends that cross the limit together call ``pause`` once.
        Returns whether the flag changed. A callback that raises is
        logged."""
        with self.ingest_lock:
            if self.paused == paused:
                return False
            self.paused = paused
            cb = self.plugin.pause if paused else self.plugin.resume
            try:
                cb()
            except Exception:
                log.exception("%s %s callback failed", self.display_name,
                              "pause" if paused else "resume")
        return True

    def configure(self) -> None:
        super().configure()
        # default tag = per-instance name (dummy.0, dummy.1, ...)
        self.tag = self.properties.get("tag") or self.plugin.default_tag or self.name
        mbl = self.properties.get("mem_buf_limit")
        self.mem_buf_limit = parse_size(mbl) if mbl else 0
        self.storage_type = self.properties.get("storage.type", "memory")
        self.pause_on_chunks_overlimit = parse_bool(self.properties.get(
            "storage.pause_on_chunks_overlimit", False))
        self.threaded = parse_bool(self.properties.get("threaded", False))


class FilterInstance(Instance):
    def __init__(self, plugin: FilterPlugin):
        super().__init__(plugin)
        #: appends the raw path's batch hook took, and the wall seconds of
        #: the most recent ones (``Engine._ingest_raw``)
        self.batch_taken = 0
        self.batch_seconds: collections.deque = collections.deque(
            maxlen=4096)
        self._batch_lock = threading.Lock()  # parallel raw appends

    def note_batch(self, seconds: float) -> None:
        with self._batch_lock:
            self.batch_taken += 1
            self.batch_seconds.append(seconds)


class OutputInstance(Instance):
    """An output, with what the engine's delivery reads of it (reference
    ``OutputInstance``, fluentbit_tpu/core/plugin.py:319-413)."""

    instance_keys = OUTPUT_INSTANCE_KEYS

    def __init__(self, plugin: OutputPlugin):
        super().__init__(plugin)
        self.retry_limit: Optional[int] = None  # None: the service's
        self.workers: int = 0
        # the guard's flush deadline for this output (None: the
        # service's guard.flush_timeout, else 2 x grace; core/guard.py)
        self.flush_timeout: Optional[float] = None
        # the flush-concurrency bound, built at configure(): 1 for a
        # synchronous or no_multiplex output, N for ``workers N``, else
        # none
        self.flush_semaphore: Optional[asyncio.Semaphore] = None
        self.worker_pool = None  # OutputWorkerPool when workers > 0
        # records failing the condition never enter this output's chunks
        self.route_condition = None
        # flb_output_set_test's formatter: takes each flush's bytes
        # instead of the plugin (src/flb_engine_dispatch.c:101-137)
        self.test_formatter: Optional[Callable] = None

    def configure(self) -> None:
        super().configure()
        conds = self.properties.get_all("route_condition")
        if conds:
            from .conditions import Condition

            self.route_condition = Condition.from_route_conditions(conds)
        ft = self.properties.get("flush_timeout")
        if ft is not None:
            self.flush_timeout = parse_time(ft)
        rl = self.properties.get("retry_limit")
        if rl is not None:
            if str(rl).lower() in ("no_limits", "false",
                                   "no_retries_forever", "unlimited"):
                self.retry_limit = -1
            else:
                self.retry_limit = int(rl)
        w = self.properties.get("workers")
        if w is not None:
            self.workers = int(w)
        if self.plugin.synchronous or self.plugin.no_multiplex or \
                parse_bool(self.properties.get("no_multiplex", False)):
            self.flush_semaphore = asyncio.Semaphore(1)
        elif self.workers > 0:
            self.flush_semaphore = asyncio.Semaphore(self.workers)


class Registry:
    """Plugin name → class registry for the input, filter and output kinds."""

    def __init__(self) -> None:
        self.inputs: Dict[str, Type[InputPlugin]] = {}
        self.filters: Dict[str, Type[FilterPlugin]] = {}
        self.outputs: Dict[str, Type[OutputPlugin]] = {}

    def register(self, cls: Type[Plugin]) -> Type[Plugin]:
        if issubclass(cls, InputPlugin):
            self.inputs[cls.name] = cls
        elif issubclass(cls, FilterPlugin):
            self.filters[cls.name] = cls
        elif issubclass(cls, OutputPlugin):
            self.outputs[cls.name] = cls
        else:
            raise TypeError(f"unknown plugin kind {cls!r}")
        return cls

    def create_input(self, name: str) -> InputInstance:
        return InputInstance(self._get(self.inputs, name, "input")())

    def create_filter(self, name: str) -> FilterInstance:
        return FilterInstance(self._get(self.filters, name, "filter")())

    def create_output(self, name: str) -> OutputInstance:
        return OutputInstance(self._get(self.outputs, name, "output")())

    @staticmethod
    def _get(table: dict, name: str, kind: str):
        cls = table.get(name)
        if cls is None:
            raise ValueError(f"unknown {kind} plugin {name!r} (have: {sorted(table)})")
        return cls


#: Default registry; plugins self-register at import via ``@registry.register``.
registry = Registry()
