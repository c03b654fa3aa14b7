"""Basic outputs: stdout, lib.

The port's own copy of the ``stdout`` and ``lib`` outputs of
``fluentbit_tpu/plugins/outputs_basic.py`` (reference: plugins/out_stdout,
plugins/out_lib). stdout prints log records as ``json_lines`` (config 1)
or in the classic ``print`` form; its other formats wait for a later
slice.
"""

from __future__ import annotations

import json
import sys

from ..codec.events import decode_events
from ..codec.msgpack import EventTime
from ..core.config import ConfigMapEntry
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
