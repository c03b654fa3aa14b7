"""filter_log_to_metrics — derive metrics (and sketches) from log records.

The port's counterpart of ``fluentbit_tpu/plugins/filter_log_to_metrics.py``.
Reference: plugins/filter_log_to_metrics/log_to_metrics.c.
Modes counter, gauge and histogram run on the host, with grep-style
pre-filter rules in legacy first-rule-decides semantics, labels from
``label_field`` record accessors plus static ``add_label`` pairs,
optional ``kubernetes_mode`` labels, and the namespace ``log_metric`` by
default. Each append that selects a record emits the registry as a
METRICS-type snapshot through a hidden emitter input, so it flows to any
metrics-capable output.

The two sketch modes (BASELINE config 4) keep their state on the
engine's device (``ops.sketch``): ``cardinality`` a HyperLogLog over
``value_field``, emitted as a gauge of its estimate; ``frequency`` a
count-min sketch, emitted as a gauge per value for the ``frequency_top_k``
hottest values among the 4096 most recently seen. Each append stages its
values into one pinned ``[B, tpu_max_record_len]`` batch and launches one
kernel (``csrc/sketch.cu`` on a GPU, its plain torch version on the CPU);
longer values hash on the host (``add_cpu``). There is no host fallback
for a device failure: it raises.

The raw path (``process_batch``, ``stateful_batch``; the reference's
filter_log_to_metrics.py:183-200 and :283-318): counter mode with static
labels only (no ``label_field``, no ``kubernetes_mode``), at least one
Regex rule, and every rule on a top-level key with a DFA. The host DFA
twin (``native.grep_match``) gives the rules' verdicts in one walk of
the chunk, ``legacy_keep_mask`` the selection, and the counter takes one
batched ``inc`` on the static label set; the snapshot emits as on the
decoded path. Other modes and label sets keep the decoded path.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, List, Optional

import torch

from .. import native
from ..codec.chunk import EVENT_TYPE_METRICS
from ..codec.msgpack import packb
from ..core.config import ConfigMapEntry
from ..core.metrics import DEFAULT_BUCKETS, MetricsRegistry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..core.record_accessor import RecordAccessor
from ..ops.batch import assemble, bucket_size, staging
from ..ops.device import DEVICE_ERRORS
from ..ops.sketch import CountMin, HyperLogLog
from .filter_grep import legacy_keep, legacy_keep_mask, parse_grep_rules

log = logging.getLogger("flb")

K8S_LABELS = ("namespace_name", "pod_name", "container_name",
              "docker_id", "pod_id")

#: the frequency mode's candidate set: the most recently seen values
_MAX_CANDIDATES = 4096


def _stringify(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


@registry.register
class LogToMetricsFilter(FilterPlugin):
    name = "log_to_metrics"
    description = "generate metrics from log records"
    # the batch hook counts and emits: a decline after it must not re-run
    stateful_batch = True
    config_map = [
        ConfigMapEntry("regex", "slist", multiple=True, slist_max_split=1),
        ConfigMapEntry("exclude", "slist", multiple=True, slist_max_split=1),
        ConfigMapEntry("metric_mode", "str", default="counter"),
        ConfigMapEntry("value_field", "str"),
        ConfigMapEntry("metric_name", "str"),
        ConfigMapEntry("metric_namespace", "str", default="log_metric"),
        ConfigMapEntry("metric_subsystem", "str", default=""),
        ConfigMapEntry("metric_description", "str"),
        ConfigMapEntry("kubernetes_mode", "bool", default=False),
        ConfigMapEntry("add_label", "slist", multiple=True, slist_max_split=1),
        ConfigMapEntry("label_field", "str", multiple=True),
        ConfigMapEntry("bucket", "str", multiple=True),
        ConfigMapEntry("tag", "str"),
        ConfigMapEntry("emitter_name", "str"),
        ConfigMapEntry("emitter_mem_buf_limit", "str", default="10M"),
        ConfigMapEntry("discard_logs", "bool", default=False),
        ConfigMapEntry("flush_interval_sec", "int", default=0),
        ConfigMapEntry("flush_interval_nsec", "int", default=0),
        ConfigMapEntry("sketch_precision", "int", default=14,
                       desc="HLL precision p (2^p registers)"),
        ConfigMapEntry("sketch_depth", "int", default=4),
        ConfigMapEntry("sketch_width", "int", default=16384),
        ConfigMapEntry("frequency_top_k", "int", default=10),
        ConfigMapEntry("tpu_max_record_len", "int", default=256),
    ]

    MODES = ("counter", "gauge", "histogram", "cardinality", "frequency")

    def init(self, instance, engine) -> None:
        if not self.metric_name:
            raise ValueError("log_to_metrics: metric_name is not set")
        if not self.metric_description:
            raise ValueError("log_to_metrics: metric_description is not set")
        if not self.tag:
            raise ValueError("log_to_metrics: Metric tag is not set")
        self.mode = (self.metric_mode or "counter").lower()
        if self.mode not in self.MODES:
            raise ValueError(f"log_to_metrics: unknown mode {self.metric_mode!r}")
        if self.mode != "counter" and not self.value_field:
            raise ValueError(f"log_to_metrics: {self.mode} requires value_field")
        self.rules = parse_grep_rules(instance.properties)

        # labels: [k8s...] + label_field accessors + add_label statics
        self.label_keys: List[str] = []
        self._label_ras: List[RecordAccessor] = []
        self._k8s_ra = (RecordAccessor("$kubernetes") if self.kubernetes_mode
                        else None)
        if self.kubernetes_mode:
            self.label_keys.extend(K8S_LABELS)
        for lf in self.label_field:
            name = lf[1:] if lf.startswith("$") else lf
            self.label_keys.append(name.replace("['", "_").replace("']", "")
                                   .replace(".", "_"))
            self._label_ras.append(
                RecordAccessor(lf if lf.startswith("$") else "$" + lf))
        self._static_labels: List[str] = []
        for pair in self.add_label:
            parts = pair if isinstance(pair, list) else pair.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"log_to_metrics: invalid add_label {pair!r}")
            self.label_keys.append(parts[0])
            self._static_labels.append(parts[1])
        self.value_ra = None
        if self.value_field:
            vf = self.value_field
            self.value_ra = RecordAccessor(vf if vf.startswith("$")
                                           else "$" + vf)

        self.device = engine.device
        #: host seconds of each sketch append's steps (staging; H2D copy,
        #: launch and overflow rows; estimate/query readback), the most
        #: recent appends only
        self.step_seconds: collections.deque = collections.deque(maxlen=4096)
        self.cmt = MetricsRegistry()
        ns, sub = self.metric_namespace, self.metric_subsystem or ""
        keys = tuple(self.label_keys)
        desc = self.metric_description
        if self.mode == "counter":
            self.metric = self.cmt.counter(ns, sub, self.metric_name, desc, keys)
        elif self.mode == "histogram":
            buckets = tuple(float(b) for b in self.bucket) or DEFAULT_BUCKETS
            self.metric = self.cmt.histogram(ns, sub, self.metric_name, desc,
                                             keys, buckets)
        elif self.mode == "frequency":
            self.metric = self.cmt.gauge(ns, sub, self.metric_name, desc,
                                         keys + ("value",))
            self.cms = CountMin(self.sketch_depth, self.sketch_width,
                                self.device)
            # value -> its count-min columns, in recency order
            self._freq_candidates: Dict[bytes, List[int]] = {}
        else:  # gauge, cardinality
            self.metric = self.cmt.gauge(ns, sub, self.metric_name, desc, keys)
            if self.mode == "cardinality":
                self.hll = HyperLogLog(self.sketch_precision, self.device)

        # the raw path: counter mode on static labels, selected by at
        # least one Regex rule (a non-map body then never matches, and
        # the first Regex rule drops it on both paths)
        self._batch_tables = None
        if (self.mode == "counter" and not self._label_ras
                and not self.kubernetes_mode and self.rules
                and any(not r.is_exclude for r in self.rules)
                and all(r.dfa is not None and not r.ra.parts
                        for r in self.rules)):
            self._batch_tables = native.GrepTables(
                [(r.ra.head.encode("utf-8"), r.dfa) for r in self.rules])
        name = self.emitter_name or f"emitter_for_{instance.display_name}"
        self.emitter = engine.hidden_input(
            "emitter", alias=name,
            mem_buf_limit=self.emitter_mem_buf_limit).plugin
        self._dirty = False
        self._interval = (self.flush_interval_sec
                          + self.flush_interval_nsec / 1e9)
        if self._interval > 0:
            # the reference's flush timer: an interval collector on the
            # hidden emitter emits throttled updates
            self.emitter.collect_interval = self._interval
            self.emitter.collect = (
                lambda _engine: self._emit_snapshot() if self._dirty else None)

    # -- per-record helpers --

    def _labels(self, body: dict) -> tuple:
        out: List[str] = []
        if self._k8s_ra is not None:
            k8s = self._k8s_ra.get(body) or {}
            for key in K8S_LABELS:
                v = k8s.get(key) if isinstance(k8s, dict) else None
                out.append(_stringify(v) if v is not None else "")
        for ra in self._label_ras:
            v = ra.get(body)
            out.append(_stringify(v) if v is not None else "")
        out.extend(self._static_labels)
        return tuple(out)

    def _value(self, body: dict) -> Optional[float]:
        v = self.value_ra.get(body)
        if isinstance(v, bool) or v is None:
            return None
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    def _value_bytes(self, body: dict) -> Optional[bytes]:
        v = self.value_ra.get(body)
        if v is None:
            return None
        return (v if isinstance(v, str) else _stringify(v)).encode("utf-8")

    # -- the raw path (engine process_batch hook) --

    def can_process_batch(self) -> bool:
        return self._batch_tables is not None

    def process_batch(self, chunk):
        data = chunk.as_bytes()
        got = native.grep_match(data, self._batch_tables, n_hint=chunk.n)
        if got is None:
            return None
        mask, _offsets, n = got
        count = int(legacy_keep_mask(self.rules, mask).sum()) if n else 0
        if count:
            # one inc of the static label set: n per-record incs
            self.metric.inc(count, tuple(self._static_labels))
            self._dirty = True
            if self._interval <= 0:
                try:
                    self._emit_snapshot()
                except DEVICE_ERRORS:
                    raise
                except Exception:
                    # the inc is committed: a raise would re-count it on
                    # the decoded tail, so the snapshot is deferred
                    # (_dirty stays set), as in the reference
                    log.exception("log_to_metrics snapshot emit failed; "
                                  "snapshot deferred")
        if self.discard_logs:
            return (0, b"", n)
        return (n, data, n)

    # -- the filter --

    def filter(self, events: list, tag: str, engine) -> tuple:
        selected = [ev for ev in events if legacy_keep(self.rules, ev.body)]
        if self.mode == "counter":
            for ev in selected:
                self.metric.inc(1, self._labels(ev.body))
        elif self.mode in ("gauge", "histogram"):
            record = (self.metric.set if self.mode == "gauge"
                      else self.metric.observe)
            for ev in selected:
                v = self._value(ev.body)
                if v is not None:
                    record(v, self._labels(ev.body))
        elif self.mode == "cardinality":
            self._update_hll(selected)
        else:
            self._update_cms(selected)
        if selected:
            self._dirty = True
            # interval 0 (the default): emit on every append
            if self._interval <= 0:
                self._emit_snapshot()
        if self.discard_logs:
            return (FilterResult.MODIFIED, [])
        return (FilterResult.NOTOUCH, events)

    def _emit_snapshot(self) -> None:
        payload = packb(self.cmt.to_msgpack_obj())
        self.emitter.add_event(self.tag, payload, EVENT_TYPE_METRICS,
                               n_records=len(self.cmt.metrics()))
        self._dirty = False

    # -- sketch modes --

    def _staged(self, values: List[bytes]):
        """Values → one ``[Bp, L]`` batch in (pinned, for a GPU) host
        buffers; returns (batch, lengths, overflow indices)."""
        L = self.tpu_max_record_len
        Bp = bucket_size(len(values), max_len=L)
        batch = staging((Bp, L), torch.uint8, self.device)
        lengths = staging((Bp,), torch.int32, self.device)
        staged = assemble(values, L, Bp, out=(batch.numpy(), lengths.numpy()))
        return batch, lengths, staged.overflow

    def _sketch_values(self, selected: list) -> List[bytes]:
        vals = (self._value_bytes(ev.body) for ev in selected)
        return [v for v in vals if v is not None]

    def _update_hll(self, selected: list) -> None:
        vals = self._sketch_values(selected)
        if not vals:
            return
        t0 = time.perf_counter()
        batch, lengths, overflow = self._staged(vals)
        t1 = time.perf_counter()
        self.hll.update(batch, lengths)
        for i in overflow:  # longer than the staged width: host hash
            self.hll.add_cpu(vals[i])
        t2 = time.perf_counter()
        labels = self._labels(selected[0].body) if self.label_keys else ()
        self.metric.set(self.hll.estimate(), labels)
        self.step_seconds.append((t1 - t0, t2 - t1, time.perf_counter() - t2))

    def _update_cms(self, selected: list) -> None:
        vals = self._sketch_values(selected)
        if not vals:
            return
        t0 = time.perf_counter()
        batch, lengths, overflow = self._staged(vals)
        t1 = time.perf_counter()
        self.cms.update(batch, lengths)
        for i in overflow:  # longer than the staged width: host hash
            self.cms.add_cpu(vals[i])
        t2 = time.perf_counter()
        cands = self._freq_candidates
        for v in vals:
            # delete-and-reinsert refreshes recency (a dict keeps
            # insertion order; reassignment would not move the key)
            cols = cands.pop(v, None) or self.cms._cols_cpu(v)
            cands[v] = cols
        for k in list(cands)[:max(0, len(cands) - _MAX_CANDIDATES)]:
            del cands[k]
        base = self._labels(selected[0].body) if self.label_keys else ()
        # one device→host table copy for the whole candidate set
        ests = self.cms.query_cols(list(cands.values()))
        top = sorted(zip(ests, cands), reverse=True)[: self.frequency_top_k]
        # the gauge reports the current top-k only
        self.metric.clear()
        for est, v in top:
            self.metric.set(est, base + (v.decode("utf-8", "replace"),))
        self.step_seconds.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
