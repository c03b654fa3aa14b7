"""Basic outputs: stdout, null, lib, file, counter, flowcounter, exit,
prometheus_exporter, retry.

The port's own copy of ``fluentbit_tpu/plugins/outputs_basic.py``
(reference: plugins/out_stdout, out_null, out_lib, out_file,
out_counter, out_flowcounter, out_exit, out_prometheus_exporter, and
out_retry, the test plugin that always answers FLB_RETRY).
stdout prints log records as ``json_lines`` (config 1) or in the classic
``print`` form; its other formats wait for a later slice. file appends
to ``<path>/<file or tag>`` and answers RETRY on any ``OSError`` (a
full disk, a directory not there yet), so the engine retries it.
prometheus_exporter keeps the latest snapshot of each metric and renders
them as Prometheus text (config 4); serving that text over HTTP waits
for the admin server's slice.
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..codec.chunk import EVENT_TYPE_LOGS, EVENT_TYPE_METRICS
from ..codec.events import decode_events
from ..codec.msgpack import EventTime, Unpacker
from ..core.config import ConfigMapEntry
from ..core.metrics import is_metrics_payload, payload_to_prometheus
from ..core.plugin import FlushResult, OutputPlugin, registry


def _json_default(o):
    if isinstance(o, EventTime):
        return float(o)
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    return str(o)


def format_json_lines(data: bytes, date_key: str = "date") -> str:
    return "\n".join(
        json.dumps({date_key: round(ev.ts_float, 9), **ev.body},
                   default=_json_default, separators=(",", ":"))
        for ev in decode_events(data))


@registry.register
class StdoutOutput(OutputPlugin):
    """plugins/out_stdout: prints records as json_lines or print."""

    name = "stdout"
    config_map = [
        ConfigMapEntry("format", "str", default="print"),
        ConfigMapEntry("json_date_key", "str", default="date"),
    ]

    def init(self, instance, engine) -> None:
        if self.format.lower() not in ("print", "json_lines"):
            raise ValueError(f"stdout: unsupported format {self.format!r}")

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        out = sys.stdout
        if self.format.lower() == "json_lines":
            out.write(format_json_lines(data, self.json_date_key) + "\n")
        else:
            # classic fluent-bit print: [idx] tag: [ts, {record}]
            for i, ev in enumerate(decode_events(data)):
                body = json.dumps(ev.body, default=_json_default)
                out.write(f"[{i}] {tag}: [{ev.ts_float:.9f}, {body}]\n")
        out.flush()
        return FlushResult.OK


@registry.register
class NullOutput(OutputPlugin):
    """plugins/out_null: discard everything (config 3's sink)."""

    name = "null"
    event_types = (EVENT_TYPE_LOGS, EVENT_TYPE_METRICS)

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        return FlushResult.OK


@registry.register
class LibOutput(OutputPlugin):
    """plugins/out_lib: hand each flush to a user callback
    ``callback(data: bytes, tag: str)``."""

    name = "lib"
    config_map = [ConfigMapEntry("callback", "raw")]

    def init(self, instance, engine) -> None:
        if self.callback is not None and not callable(self.callback):
            raise TypeError("out_lib callback must be callable")

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        if self.callback is not None:
            self.callback(data, tag)
        return FlushResult.OK


@registry.register
class FileOutput(OutputPlugin):
    """plugins/out_file: append records to ``<path>/<file or tag>``, one
    line a record: ``out_file`` (``tag: [ts, record]``), ``plain`` (the
    record's JSON) or ``json_lines`` (the JSON with ``date`` first)."""

    name = "file"
    config_map = [
        ConfigMapEntry("path", "str", default="."),
        ConfigMapEntry("file", "str"),
        ConfigMapEntry("format", "str", default="out_file"),
        ConfigMapEntry("mkdir", "bool", default="false"),
    ]

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        path = os.path.join(self.path or ".", self.file or tag)
        fmt = (self.format or "out_file").lower()
        try:
            if self.mkdir:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                for ev in decode_events(data):
                    body = json.dumps(ev.body, default=_json_default)
                    if fmt == "plain":
                        f.write(body + "\n")
                    elif fmt == "json_lines":
                        f.write(json.dumps({"date": ev.ts_float, **ev.body},
                                           default=_json_default) + "\n")
                    else:
                        f.write(f"{tag}: [{ev.ts_float:.9f}, {body}]\n")
        except OSError:
            return FlushResult.RETRY
        return FlushResult.OK


@registry.register
class CounterOutput(OutputPlugin):
    """plugins/out_counter: prints the cumulative record count a flush."""

    name = "counter"

    def init(self, instance, engine) -> None:
        self.total = 0

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        self.total += len(decode_events(data))
        sys.stdout.write(
            f"{time.time():.9f},{self.total} (total = {self.total})\n")
        return FlushResult.OK


@registry.register
class FlowCounterOutput(OutputPlugin):
    """plugins/out_flowcounter: records and bytes a tag
    (``counts[tag] = [records, bytes]``)."""

    name = "flowcounter"
    config_map = [ConfigMapEntry("unit", "str", default="minute")]

    def init(self, instance, engine) -> None:
        self.counts = {}

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        cnt = self.counts.setdefault(tag, [0, 0])
        cnt[0] += len(decode_events(data))
        cnt[1] += len(data)
        return FlushResult.OK


@registry.register
class ExitOutput(OutputPlugin):
    """plugins/out_exit: stops the engine after ``flush_count`` flushes."""

    name = "exit"
    config_map = [ConfigMapEntry("flush_count", "int", default=1)]

    def init(self, instance, engine) -> None:
        self._seen = 0

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        self._seen += 1
        if self._seen >= self.flush_count:
            engine.request_stop()
        return FlushResult.OK


@registry.register
class RetryOutput(OutputPlugin):
    """plugins/out_retry: always answers RETRY (exercises the retry
    scheduler); ``attempts`` counts its flushes."""

    name = "retry"

    def init(self, instance, engine) -> None:
        self.attempts = 0

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        self.attempts += 1
        return FlushResult.RETRY


def _metrics_payloads(data: bytes) -> list:
    """The metrics snapshots of a METRICS-type chunk (one per emitter
    append); empty when the chunk holds anything else."""
    out = []
    try:
        for obj in Unpacker(data):
            if not is_metrics_payload(obj):
                return []
            out.append(obj)
    except Exception:
        return []  # not msgpack: the flush answers ERROR
    return out


@registry.register
class PrometheusExporterOutput(OutputPlugin):
    """plugins/out_prometheus_exporter: keeps the latest snapshot of each
    metric from metrics-type chunks; ``render()`` gives the exposition
    (BASELINE config 4's sink)."""

    name = "prometheus_exporter"
    event_types = (EVENT_TYPE_METRICS,)
    config_map = [
        ConfigMapEntry("add_label", "slist", multiple=True, slist_max_split=1),
    ]

    def init(self, instance, engine) -> None:
        self._payloads = {}  # metric fqname -> latest metric entry
        self._extra = []
        for pair in self.add_label:
            parts = pair if isinstance(pair, list) else pair.split(None, 1)
            if len(parts) == 2:
                self._extra.append((parts[0], parts[1]))

    async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
        payloads = _metrics_payloads(data)
        if not payloads:
            return FlushResult.ERROR
        # snapshots are cumulative per source registry, and a chunk may
        # carry several filters' snapshots: the last of each metric wins
        extra_keys = [k for k, _ in self._extra]
        extra_vals = [v for _, v in self._extra]
        for payload in payloads:
            for m in payload.get("metrics", []):
                entry = dict(m)
                if self._extra:
                    entry["labels"] = list(m.get("labels", [])) + extra_keys
                    entry["values"] = [
                        {"labels": list(s.get("labels", [])) + extra_vals,
                         "value": s.get("value")}
                        for s in m.get("values", [])]
                    entry["hist"] = [
                        {**h, "labels": list(h.get("labels", [])) + extra_vals}
                        for h in m.get("hist", [])]
                self._payloads[m.get("name", "")] = entry
        return FlushResult.OK

    def render(self) -> str:
        return payload_to_prometheus(
            {"meta": {}, "metrics": list(self._payloads.values())})
