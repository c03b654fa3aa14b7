"""Metrics — the cmetrics equivalent that log_to_metrics fills.

The port's own copy of ``fluentbit_tpu/core/metrics.py``, trimmed to
what filter_log_to_metrics, prometheus_exporter and the flux exporter
need: counters, gauges and histograms in a registry, the registry as a
msgpack-ready payload (metrics flow *as data* through the pipeline), and
that payload rendered as Prometheus text, character for character as
the reference package renders it.

Reference: lib/cmetrics (cmt_counter/cmt_gauge/cmt_histogram) and the
Prometheus text encoder of out_prometheus_exporter.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Iterable, List, Sequence, Tuple

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Metric:
    kind = ""

    def __init__(self, registry: "MetricsRegistry", ns: str, subsystem: str,
                 name: str, desc: str, label_keys: Sequence[str] = ()):
        self.ns = ns
        self.subsystem = subsystem
        self.name = name
        self.desc = desc
        self.label_keys = tuple(label_keys)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = registry._lock
        registry._add(self)

    @property
    def fqname(self) -> str:
        return "_".join(p for p in (self.ns, self.subsystem, self.name) if p)

    def _key(self, labels: Sequence[str]) -> Tuple[str, ...]:
        labels = tuple(str(x) for x in labels)
        if len(labels) != len(self.label_keys):
            raise ValueError(f"{self.fqname}: expected "
                             f"{len(self.label_keys)} labels, got {len(labels)}")
        return labels

    def samples(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return list(self._values.items())

    def get(self, labels: Sequence[str] = ()) -> float:
        """One series' value (a histogram's: its count); 0 if unset."""
        k = self._key(labels)
        with self._lock:
            return self._values.get(k, 0.0)

    def clear(self) -> None:
        """Drop every labeled series (frequency-mode top-k refresh)."""
        with self._lock:
            self._values.clear()

    def remove_matching(self, label_key: str, value: str) -> None:
        """Drop only the series whose ``label_key`` equals ``value``: the
        refresh of one publisher in a family that several share (the
        flux exporters all write ``fluentbit_flux_*``)."""
        with self._lock:
            try:
                i = self.label_keys.index(label_key)
            except ValueError:
                return
            for k in [k for k in self._values if k[i] == value]:
                del self._values[k]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, labels: Sequence[str] = ()) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: Sequence[str] = ()) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def set_max(self, value: float, labels: Sequence[str] = ()) -> None:
        """Keep the largest value ever set (a high-water mark)."""
        k = self._key(labels)
        with self._lock:
            if value > self._values.get(k, float("-inf")):
                self._values[k] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, ns, subsystem, name, desc,
                 label_keys: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, ns, subsystem, name, desc, label_keys)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, labels: Sequence[str] = ()) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.get(k)
            if counts is None:
                counts = self._counts[k] = [0] * (len(self.buckets) + 1)
            counts[bisect.bisect_left(self.buckets, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._values[k] = self._values.get(k, 0.0) + 1  # total count

    def hist_samples(self):
        with self._lock:
            return {k: (list(v), self._sums.get(k, 0.0))
                    for k, v in self._counts.items()}


class MetricsRegistry:
    """A cmt context. Get-or-create runs under the registry's reentrant
    lock (the metric constructor re-enters it), so two threads asking
    for one name get the same object."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _add(self, metric: _Metric) -> None:
        with self._lock:
            self._metrics[metric.fqname] = metric

    def _get_or_create(self, cls, ns, subsystem, name, *args):
        key = "_".join(p for p in (ns, subsystem, name) if p)
        with self._lock:
            m = self._metrics.get(key)
            if isinstance(m, cls):
                return m
            return cls(self, ns, subsystem, name, *args)

    def counter(self, ns: str, subsystem: str, name: str, desc: str = "",
                label_keys: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, ns, subsystem, name, desc,
                                   label_keys)

    def gauge(self, ns: str, subsystem: str, name: str, desc: str = "",
              label_keys: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, ns, subsystem, name, desc,
                                   label_keys)

    def histogram(self, ns: str, subsystem: str, name: str, desc: str = "",
                  label_keys: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, ns, subsystem, name, desc,
                                   label_keys, buckets)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def to_prometheus(self) -> str:
        """The registry as Prometheus text."""
        return payload_to_prometheus(self.to_msgpack_obj())

    def to_msgpack_obj(self) -> dict:
        """The registry as a plain structure for the metrics pipeline."""
        ts = time.time()
        metrics = []
        for m in self.metrics():
            entry = {
                "name": m.fqname,
                "type": m.kind,
                "desc": m.desc,
                "labels": list(m.label_keys),
                "ts": ts,
                "values": [{"labels": list(k), "value": v}
                           for k, v in m.samples()],
            }
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
                entry["hist"] = [{"labels": list(k), "counts": c, "sum": s}
                                 for k, (c, s) in m.hist_samples().items()]
            metrics.append(entry)
        return {"meta": {"ts": ts}, "metrics": metrics}


def payload_to_prometheus(obj: dict) -> str:
    """Render a metrics payload (``MetricsRegistry.to_msgpack_obj``'s
    shape) as Prometheus text."""
    out: List[str] = []
    for m in obj.get("metrics", []):
        fq = m.get("name", "")
        if m.get("desc"):
            out.append(f"# HELP {fq} {m['desc']}")
        out.append(f"# TYPE {fq} {m.get('type', 'untyped')}")
        keys = tuple(m.get("labels", []))
        if m.get("type") == "histogram":
            buckets = m.get("buckets", [])
            for h in m.get("hist", []):
                labels = tuple(h.get("labels", []))
                base = _fmt_labels(keys, labels)
                cum = 0
                counts = h.get("counts", [])
                for b, c in zip(buckets, counts):
                    cum += c
                    le = _fmt_labels(keys + ("le",), labels + (_fmt_float(b),))
                    out.append(f"{fq}_bucket{le} {cum}")
                if len(counts) > len(buckets):
                    cum += counts[-1]
                le = _fmt_labels(keys + ("le",), labels + ("+Inf",))
                out.append(f"{fq}_bucket{le} {cum}")
                out.append(f"{fq}_sum{base} {_fmt_float(h.get('sum', 0.0))}")
                out.append(f"{fq}_count{base} {cum}")
        else:
            for s in m.get("values", []):
                out.append(
                    f"{fq}{_fmt_labels(keys, tuple(s.get('labels', [])))} "
                    f"{_fmt_float(s.get('value', 0.0))}")
    return "\n".join(out) + "\n"


def is_metrics_payload(obj) -> bool:
    return isinstance(obj, dict) and "metrics" in obj and "meta" in obj


def _fmt_labels(keys: Sequence[str], values: Sequence[str]) -> str:
    if not keys:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in zip(keys, values)) + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_float(v: float) -> str:
    """``4`` for an integral value below 1e15, else ``repr`` (``4.5``)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
