"""fluentbit_flux_* metrics exporter — flux state → core.metrics.

The port of ``fluentbit_tpu/flux/exporter.py``. Publishes one flux state
into a :class:`MetricsRegistry` (the engine's):

- ``fluentbit_flux_records_total{name}``        absorbed records
- ``fluentbit_flux_batches_total{name}``        absorbed appends
- ``fluentbit_flux_late_records_total{name}``   event-time late drops
- ``fluentbit_flux_window_emits_total{name}``   closed-window emissions
- ``fluentbit_flux_groups{name}``               open-pane group count
- ``fluentbit_flux_cardinality{name,group,field}``  HLL estimates
- ``fluentbit_flux_topk_estimate{name,group,value}`` CMS hot keys

Gauge families are refreshed wholesale (this state's series removed, then
set), so groups that age out of the window leave the exposition. A
refresh reads every live group's registers with one device→host copy
per distinct field and the count-min table with one more.
"""

from __future__ import annotations

from ..core.metrics import MetricsRegistry
from .state import FluxState

__all__ = ["FluxExporter"]


def _group_label(key: tuple) -> str:
    """Unambiguous label for a (possibly multi-field) group key: '/'
    inside a part is escaped and a missing (None) part renders
    differently from an empty string."""
    if not key:
        return ""
    return "/".join(
        "\\N" if part is None
        else part.decode("utf-8", "replace")
        .replace("\\", "\\\\").replace("/", "\\/")
        for part in key
    )


class FluxExporter:
    """One state's exporter; ``refresh()`` runs per window close and is
    rate-limited for per-absorb calls (``min_interval`` seconds, 0 =
    always)."""

    def __init__(self, metrics: MetricsRegistry, state: FluxState,
                 min_interval: float = 0.0, now=None):
        import time as _time

        self.state = state
        self.name = state.spec.name
        self.min_interval = float(min_interval)
        self._now = now or _time.time
        self._last = 0.0
        m = metrics
        self.m_records = m.counter(
            "fluentbit", "flux", "records_total",
            "Records absorbed by the flux plane", ("name",))
        self.m_batches = m.counter(
            "fluentbit", "flux", "batches_total",
            "Chunks absorbed by the flux plane", ("name",))
        self.m_late = m.counter(
            "fluentbit", "flux", "late_records_total",
            "Event-time records behind the watermark", ("name",))
        self.m_emits = m.counter(
            "fluentbit", "flux", "window_emits_total",
            "Closed-window emissions", ("name",))
        self.m_groups = m.gauge(
            "fluentbit", "flux", "groups",
            "Open-pane group count", ("name",))
        self.m_cardinality = m.gauge(
            "fluentbit", "flux", "cardinality",
            "HLL distinct-value estimates", ("name", "group", "field"))
        self.m_topk = m.gauge(
            "fluentbit", "flux", "topk_estimate",
            "Count-min hot-key estimates", ("name", "group", "value"))
        # counters export deltas; these remember what was already added
        self._c_records = 0
        self._c_batches = 0
        self._c_late = 0
        self._c_emits = 0

    def refresh(self, force: bool = True) -> bool:
        """Publish the current state; ``force=False`` applies the rate
        limit (the per-absorb call site)."""
        now = self._now()
        if not force and self.min_interval > 0 \
                and now - self._last < self.min_interval:
            return False
        self._last = now
        st = self.state
        self._bump(self.m_records, "_c_records", st.records_total)
        self._bump(self.m_batches, "_c_batches", st.batches_total)
        self._bump(self.m_late, "_c_late", st.late_records_total)
        self._bump(self.m_emits, "_c_emits", st.window_emits_total)
        groups = st.live_groups()
        self.m_groups.set(float(len(groups)), (self.name,))
        # wholesale refresh of THIS state's series only: sibling
        # exporters share the families
        self.m_cardinality.remove_matching("name", self.name)
        self.m_topk.remove_matching("name", self.name)
        labels = [_group_label(key) for key, _g in groups]
        for label, est in zip(labels, st.estimates(groups)):
            for field, value in est.items():
                self.m_cardinality.set(value, (self.name, label, field))
        if st.cms is not None and groups:
            # live groups only: historical groups stay queryable through
            # FluxState.topk, they leave the exposition with the window
            table = st.host_table()
            for label, (key, _g) in zip(labels, groups):
                for est, value in st.topk(key, table):
                    self.m_topk.set(
                        float(est),
                        (self.name, label,
                         value.decode("utf-8", "replace")))
        return True

    def _bump(self, counter, attr: str, total: int) -> None:
        prev: int = getattr(self, attr)
        if total > prev:
            counter.inc(total - prev, (self.name,))
            setattr(self, attr, total)
