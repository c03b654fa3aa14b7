"""Basic inputs: dummy, lib.

The port's own copy of the ``dummy`` and ``lib`` inputs of
``fluentbit_tpu/plugins/inputs_basic.py``. Reference: plugins/in_dummy
(bench generator with rate/copies/samples, in_dummy.c:514-548),
plugins/in_lib (embedding injection).
"""

from __future__ import annotations

import json

from ..codec.events import encode_event, now_event_time
from ..codec.msgpack import EventTime
from ..core.config import ConfigMapEntry
from ..core.plugin import InputPlugin, registry


@registry.register
class DummyInput(InputPlugin):
    """Generates synthetic records (the benchmark source).

    Reference options (plugins/in_dummy/in_dummy.c:514-548): dummy (JSON
    message), rate (records/sec), copies (records per tick), samples (stop
    after N), start_time_sec/nsec, fixed_timestamp, flush_on_startup.
    """

    name = "dummy"
    config_map = [
        ConfigMapEntry("dummy", "str", default='{"message":"dummy"}'),
        ConfigMapEntry("rate", "int", default=1),
        ConfigMapEntry("copies", "int", default=1),
        ConfigMapEntry("samples", "int", default=0),
        ConfigMapEntry("metadata", "str", default="{}"),
        ConfigMapEntry("start_time_sec", "int", default=-1),
        ConfigMapEntry("start_time_nsec", "int", default=-1),
        ConfigMapEntry("fixed_timestamp", "bool", default="false"),
        ConfigMapEntry("flush_on_startup", "bool", default="false"),
    ]

    def init(self, instance, engine) -> None:
        self._ins = instance
        try:
            self._body = json.loads(self.dummy)
        except json.JSONDecodeError:
            self._body = {"message": "dummy"}
        try:
            self._meta = json.loads(self.metadata) or {}
        except json.JSONDecodeError:
            self._meta = {}
        self._emitted = 0
        # high rates cannot ride the timer (asyncio resolution ~ms, the
        # round-1 load-generation ceiling): cap the tick frequency at
        # 100 Hz and emit rate×interval records per tick in ONE batched
        # append (they share the tick's timestamp, like `copies`)
        if self.rate > 100:
            self.collect_interval = 0.01
            self._per_tick = max(1, int(round(self.rate * 0.01)))
        else:
            self.collect_interval = 1.0 / max(1, self.rate)
            self._per_tick = 1
        if self.start_time_sec >= 0:
            self._fixed_ts = EventTime(self.start_time_sec,
                                       max(0, self.start_time_nsec))
        elif self.fixed_timestamp:
            self._fixed_ts = now_event_time()
        else:
            self._fixed_ts = None
        if self.flush_on_startup:
            self.collect(engine)

    def collect(self, engine) -> None:
        if self.samples and self._emitted >= self.samples:
            return
        ts = self._fixed_ts or now_event_time()
        n = self.copies * self._per_tick
        if self.samples:
            n = min(n, self.samples - self._emitted)
        buf = b"".join(
            encode_event(dict(self._body), ts, dict(self._meta)) for _ in range(n)
        )
        ret = engine.input_log_append(self._ins, self._ins.tag, buf, n)
        if ret >= 0:  # -1 = rejected by backpressure: don't burn the budget
            self._emitted += n


@registry.register
class LibInput(InputPlugin):
    """Embedding-mode injection (plugins/in_lib): records arrive via
    flb_lib_push as JSON text; accepts a JSON object, array of objects, or
    NDJSON lines."""

    name = "lib"

    def init(self, instance, engine) -> None:
        self._ins = instance
        self._engine = engine

    def push(self, data) -> int:
        """flb_lib_push equivalent. Returns records ingested."""
        if isinstance(data, bytes):
            data = data.decode("utf-8", "replace")
        records = []
        data = data.strip()
        if not data:
            return 0
        try:
            obj = json.loads(data)
            if isinstance(obj, list):
                # reference in_lib accepts [ts, map] pairs and arrays of maps
                if len(obj) == 2 and isinstance(obj[0], (int, float)) and isinstance(obj[1], dict):
                    records.append((obj[0], obj[1]))
                else:
                    for item in obj:
                        if isinstance(item, dict):
                            records.append((None, item))
                        elif (
                            isinstance(item, list) and len(item) == 2
                            and isinstance(item[0], (int, float)) and isinstance(item[1], dict)
                        ):
                            records.append((item[0], item[1]))
            elif isinstance(obj, dict):
                records.append((None, obj))
        except json.JSONDecodeError:
            for line in data.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    if isinstance(obj, dict):
                        records.append((None, obj))
                except json.JSONDecodeError:
                    continue
        if not records:
            return 0
        buf = b"".join(
            encode_event(body, EventTime.from_float(ts) if ts is not None else None)
            for ts, body in records
        )
        ret = self._engine.input_log_append(self._ins, self._ins.tag, buf, len(records))
        return max(0, ret)  # -1 (backpressure) → 0 ingested, like flb_lib_push
