"""Embedding API — the library mode, on an explicit torch device.

The port's counterpart of ``fluentbit_tpu/lib.py`` (reference:
src/flb_lib.c + include/fluent-bit/flb_lib.h: flb_create / flb_input /
flb_filter / flb_output / flb_*_set / flb_start / flb_stop / flb_lib_push /
flb_output_set_test).

Usage::

    import fluentbit_tpu_torch as flb
    ctx = flb.create(flush="50ms")            # device="cuda" by default
    in_ffd = ctx.input("lib")
    ctx.filter("grep", match="*", regex="log aa")
    ctx.output("lib", callback=cb)
    ctx.output("file", match="*", path="/var/log/out", retry_limit="5",
               workers="2")
    ctx.sp_task("CREATE STREAM s WITH (tag='sp.out') AS SELECT COUNT(*) "
                "FROM TAG:'*' WINDOW TUMBLING (60 SECOND);")
    ctx.start()
    ctx.push(in_ffd, '{"log": "aa"}')
    ctx.stop()
"""

from __future__ import annotations

from typing import Callable

from .core.config import ServiceConfig
from .core.engine import Engine
from .core.plugin import InputInstance, OutputInstance
from .ops.device import DeviceLike, resolve

# ensure plugin registration
from . import plugins as _plugins  # noqa: F401


class FLBContext:
    """flb_ctx_t equivalent."""

    def __init__(self, device: DeviceLike = None, **service_props):
        self.device = resolve(device)
        self.service = ServiceConfig()
        for k, v in service_props.items():
            self.service.set(k, v)
        self.engine = Engine(self.service, self.device)
        self._handles: list = []

    # -- configuration (returns integer handles like the C API's ffd) --

    def input(self, name: str, **props) -> int:
        self._handles.append(self.engine.input(name, **props))
        return len(self._handles) - 1

    def filter(self, name: str, **props) -> int:
        self._handles.append(self.engine.filter(name, **props))
        return len(self._handles) - 1

    def output(self, name: str, **props) -> int:
        self._handles.append(self.engine.output(name, **props))
        return len(self._handles) - 1

    def set(self, ffd: int, **props) -> None:
        """flb_input_set / flb_filter_set / flb_output_set: repeated calls
        accumulate multi-value keys (grep's Regex/Exclude rules)."""
        for k, v in props.items():
            self._handles[ffd].set(k, v)

    def output_set_test(self, ffd: int, mode: str,
                        callback: Callable) -> None:
        """flb_output_set_test: in ``"formatter"`` mode each flush's
        bytes go to ``callback(data, tag)`` instead of the plugin, and
        count as delivered unless it raises
        (src/flb_engine_dispatch.c:101-137)."""
        ins = self._handles[ffd]
        if not isinstance(ins, OutputInstance):
            raise TypeError("handle is not an output")
        if mode != "formatter":
            raise ValueError(f"unknown test mode {mode!r}")
        ins.test_formatter = callback

    def service_set(self, **props) -> None:
        """[SERVICE] properties after create (the config loader's path)."""
        for k, v in props.items():
            self.service.set(k, v)

    def sp_task(self, sql: str):
        """Register a stream-processor SQL query ([STREAM_TASK] Exec):
        ``Engine.sp_task``. Its result rows enter the pipeline under the
        query's ``tag`` (or its stream name) through the SP's hidden
        emitter; a sketch-eligible query keeps its state on the
        context's device."""
        return self.engine.sp_task(sql)

    def parser(self, name: str, **props):
        """Create + register a named parser (flb_parser_create / the
        [PARSER] section's properties: Format, Regex, Time_Key,
        Time_Format, Types, ...)."""
        return self.engine.parser(name, **props)

    # -- lifecycle --

    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    # -- data --

    def push(self, ffd: int, data) -> int:
        """flb_lib_push: inject JSON into an in_lib instance."""
        ins = self._handles[ffd]
        if not isinstance(ins, InputInstance):
            raise TypeError("handle is not an input")
        push = getattr(ins.plugin, "push", None)
        if push is None:
            raise TypeError(f"input {ins.name} does not accept pushes")
        return push(data)

    def flush_now(self) -> None:
        self.engine.flush_now()

    @property
    def metrics(self):
        """The engine's registry: the input, filter and output counter
        families, uptime, delivery latency and the filters' own."""
        return self.engine.metrics

    def bound_port(self, ffd: int):
        """The port a server input (forward, http) listens on once
        ``start()`` returned: its ``port`` 0 picks a free one."""
        return self._handles[ffd].plugin.bound_port


def create(device: DeviceLike = None, **service_props) -> FLBContext:
    """flb_create equivalent. ``device`` defaults to ``cuda`` and raises
    where CUDA is absent; pass ``device="cpu"`` for the plain torch path."""
    return FLBContext(device, **service_props)
