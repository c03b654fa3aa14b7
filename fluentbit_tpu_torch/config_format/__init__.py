"""Config formats — classic INI and YAML → ordered sections → a context.

The port's own copy of ``fluentbit_tpu/config_format/__init__.py``
(reference: src/config_format/flb_config_format.c, flb_cf_fluentbit.c
for the classic mode with ``@SET`` / ``@INCLUDE``, flb_cf_yaml.c for
YAML; ``${VAR}`` interpolation as src/flb_env.c). ``load_config_file``
dispatches by extension (.yaml/.yml → YAML, else classic) and
``apply_to_context`` materializes the sections onto an ``FLBContext``:
``[SERVICE]`` keys (``parsers_file`` and ``streams_file`` load their
files), ``[PARSER]``, ``[STREAM_TASK]``, then every ``[INPUT]``,
``[FILTER]`` and ``[OUTPUT]`` in order.

What the port does not have raises by name: per-instance processors
(YAML ``processors:``), shared-object plugins (``[PLUGINS]``,
``plugins_file``, YAML ``plugins:``), multiline parsers and
``[CUSTOM]`` sections. ``yaml`` is imported only when a YAML file is
read; without PyYAML that raises.
"""

from __future__ import annotations

import glob as _glob
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


@dataclass
class Section:
    """One config section: name + ordered key/value properties."""

    name: str  # lowercased: service|input|filter|output|parser|...
    properties: List[Tuple[str, Any]] = field(default_factory=list)
    # per-instance processor pipelines (YAML only; not ported)
    processors: Dict[str, list] = field(default_factory=dict)

    def get(self, key: str, default=None):
        k = key.lower()
        for pk, v in self.properties:
            if pk.lower() == k:
                return v
        return default


@dataclass
class ConfigFile:
    sections: List[Section] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)  # @SET variables


def _interp(value: str, extra_env: Dict[str, str]) -> str:
    """${VAR} interpolation (flb_env: the environment wins over @SET
    definitions; an unknown variable expands empty)."""

    def sub(m):
        name = m.group(1)
        return os.environ.get(name, extra_env.get(name, ""))

    return _ENV_RE.sub(sub, value)


# ---------------------------------------------------------------- classic

def parse_classic(text: str, base_dir: str = ".",
                  env: Optional[Dict[str, str]] = None) -> ConfigFile:
    """Classic fluent-bit INI mode (flb_cf_fluentbit.c)."""
    cf = ConfigFile(env=dict(env or {}))
    current: Optional[Section] = None
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("@"):
            parts = line.split(None, 1)
            cmd = parts[0].upper()
            arg = parts[1].strip() if len(parts) > 1 else ""
            if cmd == "@SET" and "=" in arg:
                k, v = arg.split("=", 1)
                cf.env[k.strip()] = v.strip()
            elif cmd == "@INCLUDE":
                pattern = arg if os.path.isabs(arg) \
                    else os.path.join(base_dir, arg)
                for path in sorted(_glob.glob(pattern)):
                    inc = load_config_file(path, env=cf.env)
                    cf.sections.extend(inc.sections)
                    cf.env.update(inc.env)
            continue
        if line.startswith("[") and line.endswith("]"):
            current = Section(line[1:-1].strip().lower())
            cf.sections.append(current)
            continue
        if current is None:
            raise ValueError(f"property outside any section: {line!r}")
        parts = line.split(None, 1)
        key = parts[0]
        value = _interp(parts[1].strip() if len(parts) > 1 else "", cf.env)
        current.properties.append((key, value))
    return cf


# ------------------------------------------------------------------- yaml

def _load_yaml(text: str):
    try:
        import yaml as _yaml
    except ImportError as e:
        raise ValueError("a YAML config needs PyYAML, which is not "
                         "installed; use the classic format") from e
    return _yaml.safe_load(text)


def parse_yaml(text: str, base_dir: str = ".",
               env: Optional[Dict[str, str]] = None) -> ConfigFile:
    """YAML mode (flb_cf_yaml.c): ``service:``, ``pipeline: {inputs,
    filters, outputs}``, ``parsers:``, ``includes:``, ``env:``. The
    sections the port cannot apply (``multiline_parsers:``,
    ``plugins:``, ``customs:``, per-instance ``processors:``) are kept
    and raise in ``apply_to_context``."""
    cf = ConfigFile(env=dict(env or {}))
    doc = _load_yaml(text) or {}
    if not isinstance(doc, dict):
        raise ValueError("YAML config root must be a mapping")

    for k, v in (doc.get("env") or {}).items():
        cf.env[str(k)] = str(v)

    def interp_val(v):
        return _interp(v, cf.env) if isinstance(v, str) else v

    def section_from(name: str, body: dict) -> Section:
        sec = Section(name)
        for k, v in body.items():
            if k == "processors" and isinstance(v, dict):
                sec.processors = v
                continue
            if isinstance(v, list):
                for item in v:
                    sec.properties.append((str(k), interp_val(item)))
            else:
                sec.properties.append((str(k), interp_val(v)))
        return sec

    for inc in doc.get("includes") or []:
        path = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        for p in sorted(_glob.glob(path)):
            sub = load_config_file(p, env=cf.env)
            cf.sections.extend(sub.sections)
            cf.env.update(sub.env)

    if isinstance(doc.get("service"), dict):
        cf.sections.append(section_from("service", doc["service"]))

    for psec in doc.get("parsers") or []:
        cf.sections.append(section_from("parser", psec))

    for msec in doc.get("multiline_parsers") or []:
        cf.sections.append(section_from("multiline_parser", msec))

    for p in doc.get("plugins") or []:
        sec = Section("plugins")
        sec.properties.append(("path", interp_val(p)))
        cf.sections.append(sec)

    pipeline = doc.get("pipeline") or {}
    for kind, sec_name in (("inputs", "input"), ("filters", "filter"),
                           ("outputs", "output")):
        for body in pipeline.get(kind) or []:
            if isinstance(body, dict):
                cf.sections.append(section_from(sec_name, body))
    for body in doc.get("customs") or []:
        cf.sections.append(section_from("custom", body))
    return cf


def load_config_file(path: str,
                     env: Optional[Dict[str, str]] = None) -> ConfigFile:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith((".yaml", ".yml")):
        return parse_yaml(text, base_dir, env)
    return parse_classic(text, base_dir, env)


# -------------------------------------------------------------- apply

#: SERVICE keys that name parser definition files
_PARSER_FILE_KEYS = ("parsers_file", "parsers_files")

#: sections the port cannot apply, with what is missing
_UNPORTED_SECTIONS = {
    "plugins": "shared-object (DSO) plugins are not ported",
    "multiline_parser": "multiline parsers are not ported",
    "custom": "custom plugins are not ported",
}


def _load_relative(value, base_dir: str, cf: ConfigFile) -> ConfigFile:
    path = value if os.path.isabs(value) else os.path.join(base_dir, value)
    return load_config_file(path, env=cf.env)


def apply_to_context(ctx, cf: ConfigFile, base_dir: str = ".") -> None:
    """Materialize a parsed config onto an FLBContext (the flb_cf →
    flb_config translation the CLI performs)."""
    for sec in cf.sections:
        if sec.name in _UNPORTED_SECTIONS:
            raise ValueError(f"[{sec.name.upper()}]: "
                             f"{_UNPORTED_SECTIONS[sec.name]}")
        if sec.processors:
            raise ValueError(f"[{sec.name.upper()}] {sec.get('name')}: "
                             "processors are not ported")
    # service first (flush and grace affect everything else)
    for sec in cf.sections:
        if sec.name != "service":
            continue
        for key, value in sec.properties:
            lk = key.lower()
            if lk in _PARSER_FILE_KEYS:
                _apply_parsers(ctx, _load_relative(value, base_dir, cf))
            elif lk == "streams_file":
                _apply_streams(ctx, _load_relative(value, base_dir, cf))
            elif lk == "plugins_file":
                raise ValueError(
                    f"plugins_file: {_UNPORTED_SECTIONS['plugins']}")
            else:
                ctx.service_set(**{lk: value})
    _apply_parsers(ctx, cf)
    _apply_streams(ctx, cf)
    for sec in cf.sections:
        if sec.name in ("service", "parser", "stream_task"):
            continue
        if sec.name not in ("input", "filter", "output"):
            raise ValueError(f"unknown config section [{sec.name}]")
        name = None
        rest = []
        for k, v in sec.properties:
            if k.lower() == "name":
                name = v
            else:
                rest.append((k, v))
        if name is None:
            raise ValueError(f"[{sec.name}] section without Name")
        make = {"input": ctx.input, "filter": ctx.filter,
                "output": ctx.output}[sec.name]
        ffd = make(name)
        for k, v in rest:
            ctx.set(ffd, **{k: v})


def _apply_parsers(ctx, cf: ConfigFile) -> None:
    for sec in cf.sections:
        if sec.name == "multiline_parser":
            raise ValueError("[MULTILINE_PARSER]: "
                             f"{_UNPORTED_SECTIONS['multiline_parser']}")
        if sec.name != "parser":
            continue
        name = {k.lower(): v for k, v in sec.properties}.get("name")
        if not name:
            raise ValueError("[PARSER] section without Name")
        props = {k: v for k, v in sec.properties if k.lower() != "name"}
        ctx.parser(name, **props)


def _apply_streams(ctx, cf: ConfigFile) -> None:
    """[STREAM_TASK] sections (the streams_file format: Name + Exec)."""
    for sec in cf.sections:
        if sec.name != "stream_task":
            continue
        sql = sec.get("exec")
        if not sql:
            raise ValueError("[STREAM_TASK] section without Exec")
        ctx.sp_task(sql)
