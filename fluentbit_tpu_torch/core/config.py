"""Typed plugin configuration — config_map equivalent.

The port's own copy of ``fluentbit_tpu/core/config.py``, trimmed to the
keys the port's plugins and engine read; every other key of the
reference's raises by name when set.

Reference: include/fluent-bit/flb_config_map.h:33-51 defines a declarative
per-plugin option schema that is auto-validated and written into plugin
context structs. Here a plugin declares ``config_map`` as a list of
ConfigMapEntry; ``apply_config_map`` validates + coerces user properties
onto the instance.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kKmMgG]?)b?\s*$")
_TIME_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)?\s*$")

_SIZE_MULT = {"": 1, "k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}
_TIME_MULT = {None: 1.0, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}

TRUE_WORDS = {"true", "on", "yes", "1", "enabled"}
FALSE_WORDS = {"false", "off", "no", "0", "disabled"}


def parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in TRUE_WORDS:
        return True
    if s in FALSE_WORDS:
        return False
    raise ValueError(f"invalid boolean value: {v!r}")


def parse_size(v: Any) -> int:
    """'10M' → bytes (flb_utils_size_to_bytes)."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(str(v))
    if not m:
        raise ValueError(f"invalid size value: {v!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def parse_time(v: Any) -> float:
    """'5s' / '100ms' → seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    m = _TIME_RE.match(str(v))
    if not m:
        raise ValueError(f"invalid time value: {v!r}")
    return float(m.group(1)) * _TIME_MULT[m.group(2)]


def split_clist(v: Any, sep: str = ",") -> List[str]:
    """Comma-separated list (config_map CLIST): parts stripped, empty
    parts dropped (in_tail's path globs)."""
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [part.strip() for part in str(v).split(sep) if part.strip()]


def split_slist(v: Any, max_split: int = -1) -> List[str]:
    """Space-separated list (config_map SLIST): respects max_split so the
    trailing element may contain spaces (grep's 'Regex key pattern with
    spaces')."""
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return str(v).split(None, max_split) if max_split >= 0 else str(v).split()


_COERCERS = {
    "raw": lambda v: v,  # pass-through (python-object properties, e.g. out_lib callback)
    "str": lambda v: str(v),
    "int": lambda v: int(str(v), 0),
    "bool": parse_bool,
    "size": parse_size,
    "time": parse_time,
    "slist": split_slist,
    "clist": split_clist,
}


@dataclass
class ConfigMapEntry:
    """One declarative plugin option."""

    name: str
    type: str = "str"  # raw|str|int|bool|size|time|slist|clist
    default: Any = None
    multiple: bool = False  # option may appear multiple times (e.g. grep rules)
    slist_max_split: int = -1
    desc: str = ""

    def coerce(self, value: Any) -> Any:
        if self.type == "slist" and self.slist_max_split >= 0:
            return split_slist(value, self.slist_max_split)
        fn = _COERCERS.get(self.type)
        if fn is None:
            raise ValueError(f"unknown config_map type {self.type!r}")
        return fn(value)


class Properties:
    """Case-insensitive property bag with multi-value support.

    Reference config keys are case-insensitive (flb_config_prop_get uses
    strcasecmp); values set multiple times accumulate (grep Regex rules).
    """

    def __init__(self) -> None:
        self._items: List[tuple] = []  # (lower_key, original_key, value)

    def set(self, key: str, value: Any) -> None:
        self._items.append((key.lower(), key, value))

    def get(self, key: str, default: Any = None) -> Any:
        k = key.lower()
        for lk, _, v in reversed(self._items):
            if lk == k:
                return v
        return default

    def get_all(self, key: str) -> List[Any]:
        """Every value of a multi-value key, in the order set."""
        k = key.lower()
        return [v for lk, _, v in self._items if lk == k]

    def items(self):
        return [(orig, v) for _, orig, v in self._items]


def apply_config_map(config_map: List[ConfigMapEntry], props: Properties,
                     target: Any, instance_keys=frozenset()) -> None:
    """Validate + coerce properties onto ``target`` attributes.

    Unknown properties raise (the reference fails startup on unknown keys).
    ``instance_keys`` are the engine's keys of this kind of instance
    (``OUTPUT_INSTANCE_KEYS``), read by the instance itself.
    Attribute name is the option name lowercased with '.' and '-' → '_'.
    """
    by_name = {e.name.lower(): e for e in config_map}
    seen_multi: Dict[str, list] = {}
    for key, value in props.items():
        lk = key.lower()
        entry = by_name.get(lk)
        if entry is None:
            if lk in CORE_INSTANCE_KEYS or lk in instance_keys:
                continue
            if lk in UNPORTED_INSTANCE_KEYS or lk.startswith("tenant."):
                raise ValueError(
                    f"property {key!r} is not ported: the port has no "
                    f"{UNPORTED_INSTANCE_KEYS.get(lk, 'qos plane')}")
            raise ValueError(f"unknown property {key!r}")
        coerced = entry.coerce(value)
        attr = _attr_name(entry.name)
        if entry.multiple:
            seen_multi.setdefault(attr, []).append(coerced)
        else:
            setattr(target, attr, coerced)
    for attr, values in seen_multi.items():
        setattr(target, attr, values)
    # defaults
    for e in config_map:
        attr = _attr_name(e.name)
        if getattr(target, attr, None) is None:
            if e.multiple:
                setattr(target, attr, [])
            elif e.default is not None:
                setattr(target, attr, e.coerce(e.default))
            else:
                setattr(target, attr, None)


def _attr_name(name: str) -> str:
    return name.lower().replace(".", "_").replace("-", "_")


# Instance-level keys consumed by the engine, valid for every plugin
# (reference: flb_input.c/flb_output.c/flb_filter.c common properties).
# ``flush_timeout``, the guard's flush deadline, is read by outputs, and
# the buffer and storage keys by inputs; every instance takes them, as in
# the reference.
CORE_INSTANCE_KEYS = {"tag", "match", "match_regex", "alias", "log_level",
                      "flush_timeout", "mem_buf_limit", "storage.type",
                      "storage.pause_on_chunks_overlimit", "threaded"}

#: the engine's keys of an output instance (``OutputInstance.configure``):
#: retries, worker threads, one flush at a time, conditional routing
OUTPUT_INSTANCE_KEYS = frozenset(
    {"retry_limit", "workers", "no_multiplex", "route_condition"})

#: the TLS keys (reference src/tls/flb_tls.c), declared in the config map
#: of each plugin that dials or listens with TLS (forward in and out, http
#: in) and read by ``core.tls``; on every other plugin they raise
TLS_CONFIG = [
    ConfigMapEntry("tls", "bool", default=False),
    ConfigMapEntry("tls.verify", "bool", default=True),
    ConfigMapEntry("tls.ca_file", "str"),
    ConfigMapEntry("tls.crt_file", "str"),
    ConfigMapEntry("tls.key_file", "str"),
    ConfigMapEntry("tls.vhost", "str"),
]

_NO_TLS = "TLS on this plugin (forward and http take it)"

#: the reference's other common keys (its CORE_INSTANCE_KEYS), which the
#: port cannot honour yet: setting one raises, naming what is missing.
#: ``host`` and ``port`` are accepted only by the plugins that declare
#: them; ``tenant.*`` keys raise with ``tenant``.
UNPORTED_INSTANCE_KEYS = {
    "tls": _NO_TLS,
    "tls.verify": _NO_TLS,
    "tls.ca_file": _NO_TLS,
    "tls.crt_file": _NO_TLS,
    "tls.key_file": _NO_TLS,
    "tls.vhost": _NO_TLS,
    "http2": "HTTP/2 outputs",
    "proxy": "HTTP proxy outputs",
    "tenant": "qos plane",
    "net.keepalive": "upstream connection pools",
    "net.keepalive_idle_timeout": "upstream connection pools",
    "net.keepalive_max_recycle": "upstream connection pools",
    "net.max_worker_connections": "upstream connection pools",
}


@dataclass
class ServiceConfig:
    """[SERVICE] section (reference src/flb_config.c + flb_config.h)."""

    flush: float = 1.0           # flush timer interval seconds
    grace: float = 5.0           # shutdown grace period
    scheduler_base: float = 5.0      # retry backoff base (flb_scheduler.h:29)
    scheduler_cap: float = 2000.0    # retry backoff cap  (flb_scheduler.h:30)
    retry_limit: int = 1             # default per-output retries
    task_map_size: int = 2048        # FLB_CONFIG_DEFAULT_TASK_MAP_SIZE
    # filesystem storage (core/storage.py): chunks of ``storage.type
    # filesystem`` inputs, the backlog, the DLQ and the forward input's
    # durable dedup ledger live under ``storage_path``. ``storage.sync``
    # and ``storage.backlog.mem_limit`` are parsed and not read, as in
    # the reference
    storage_path: Optional[str] = None
    storage_sync: str = "normal"
    storage_checksum: bool = False
    storage_backlog_mem_limit: int = 5 * 1024 * 1024
    storage_max_chunks_up: int = 128  # the pause_on_chunks_overlimit bound
    # SIGHUP in the CLI: a validated full-restart reload
    hot_reload: bool = False
    # core/guard.py: flush deadlines, a breaker on every output (and the
    # forward output's destinations), the watchdog and breaker shedding
    guard_enable: bool = True
    guard_flush_timeout: float = 0.0     # 0: the deadline is 2 x grace
    guard_breaker_failures: int = 5      # consecutive failures to open
    guard_breaker_error_rate: float = 0.5  # windowed failure fraction
    guard_breaker_window: int = 20       # outcomes in the rate window
    guard_breaker_cooldown: float = 5.0  # open → half-open delay
    guard_breaker_probes: int = 1        # half-open successes to close
    guard_shed_watermark: float = 0.8    # task-map occupancy fraction
    guard_stall_after: float = 30.0      # heartbeat age: "stalled"
    guard_leak_grace: float = 5.0        # soft-kill to leaked-thread count
    guard_worker_start_timeout: float = 10.0  # worker pool start bound

    _KEYMAP = {
        "flush": ("flush", parse_time),
        "grace": ("grace", parse_time),
        "scheduler.base": ("scheduler_base", parse_time),
        "scheduler.cap": ("scheduler_cap", parse_time),
        "retry_limit": ("retry_limit", int),
        "task_map_size": ("task_map_size", int),
        "storage.path": ("storage_path", str),
        "storage.sync": ("storage_sync", str),
        "storage.checksum": ("storage_checksum", parse_bool),
        "storage.backlog.mem_limit": ("storage_backlog_mem_limit",
                                      parse_size),
        "storage.max_chunks_up": ("storage_max_chunks_up", int),
        "hot_reload": ("hot_reload", parse_bool),
        "guard.enable": ("guard_enable", parse_bool),
        "guard.flush_timeout": ("guard_flush_timeout", parse_time),
        "guard.breaker_failures": ("guard_breaker_failures", int),
        "guard.breaker_error_rate": ("guard_breaker_error_rate", float),
        "guard.breaker_window": ("guard_breaker_window", int),
        "guard.breaker_cooldown": ("guard_breaker_cooldown", parse_time),
        "guard.breaker_probes": ("guard_breaker_probes", int),
        "guard.shed_watermark": ("guard_shed_watermark", float),
        "guard.stall_after": ("guard_stall_after", parse_time),
        "guard.leak_grace": ("guard_leak_grace", parse_time),
        "guard.worker_start_timeout":
            ("guard_worker_start_timeout", parse_time),
    }

    def set(self, key: str, value: Any) -> None:
        lk = key.lower()
        mapped = self._KEYMAP.get(lk)
        if mapped is None:
            if lk in UNPORTED_SERVICE_KEYS or lk.split(".")[0] in (
                    "qos", "tpu"):
                raise ValueError(f"service property {key!r} is not "
                                 "ported")
            raise ValueError(f"unknown service property {key!r}")
        attr, fn = mapped
        setattr(self, attr, fn(value))


#: the reference's other [SERVICE] keys (its ServiceConfig._KEYMAP,
#: beside the ``qos.*`` and ``tpu.*`` families): each
#: raises when set
UNPORTED_SERVICE_KEYS = {
    "daemon", "log_level", "http_server", "http_listen", "http_port",
    "hot_reload_diff",
}
