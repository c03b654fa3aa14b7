"""in_emitter — internal re-ingestion input.

The port's own copy of ``fluentbit_tpu/plugins/in_emitter.py``
(reference: plugins/in_emitter/emitter.c). A passive input with no
collector: a filter creates one hidden instance for itself
(``engine.hidden_input``) and pushes records into it — log records
through the whole ingest path, metrics snapshots as typed appends.
"""

from __future__ import annotations

from ..core.config import ConfigMapEntry
from ..core.plugin import InputPlugin, registry


@registry.register
class EmitterInput(InputPlugin):
    name = "emitter"
    description = "internal re-ingestion channel"
    config_map = [
        ConfigMapEntry("ring_buffer_size", "int", default=0,
                       desc="accepted for parity; ingest is direct"),
    ]

    def init(self, instance, engine) -> None:
        self._engine = engine

    def add_record(self, tag: str, data: bytes, n_records: int = 1) -> int:
        """in_emitter_add_record: append encoded log events under
        ``tag`` through the filter chain. Returns the records written."""
        return self._engine.input_log_append(self.instance, tag, data,
                                             n_records)

    def add_event(self, tag: str, data: bytes, event_type: str,
                  n_records: int = 1) -> int:
        """Typed append (a metrics snapshot): no filter chain."""
        return self._engine.input_event_append(self.instance, tag, data,
                                               event_type, n_records)
