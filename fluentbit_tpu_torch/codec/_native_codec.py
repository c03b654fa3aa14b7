"""Load the port's event codec extension (``csrc/codec_py.cpp``).

The port's counterpart of ``fluentbit_tpu/codec/_native_codec.py``. The
first call builds the extension with ``g++`` into
``fluentbit_tpu_torch/_build/`` (``ops/cuda_build.py``), imports it as
``fbtpu_torch_codec`` and registers the port's ``LogEvent`` and
``EventTime`` with it, once and under a lock. A failed build, or an
interpreter without ``Python.h``, raises DeviceError naming the file:
there is no pure-Python stand-in and no switch that turns the codec off,
and a later call tries again.
"""

from __future__ import annotations

import functools
import threading

_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _build_and_init():
    from ..ops import cuda_build
    from .events import LogEvent
    from .msgpack import EventTime

    mod = cuda_build.libraries.load("codec_py")
    mod._init(LogEvent, EventTime)
    return mod


@functools.lru_cache(maxsize=None)
def load():
    """The initialised extension module. Lock-free once loaded (a cache
    hit): ``encode_event`` calls this once a record."""
    with _lock:
        return _build_and_init()
