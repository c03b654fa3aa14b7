"""The flux plane — per-tenant streaming analytics inside the filter pass.

The port of ``fluentbit_tpu/flux/``: per-group HLL cardinality, count-min
hot keys and windowed count/sum/min/max/avg, computed at ingest on the
engine's device (FLUX.md).

- ``state``    — :class:`FluxState`: per-group sketches + window panes,
  snapshot/restore (the reference's snapshot format, both ways);
- ``kernels``  — ``segment_counts`` (K9) and ``fused_absorb`` (K10),
  each a CUDA kernel in ``csrc/sketch.cu`` with its plain torch version;
- ``plugin``   — ``filter_flux`` on the decoded path;
- ``exporter`` — the ``fluentbit_flux_*`` metrics families.
"""

from .state import FluxSpec, FluxState, WindowSpec  # noqa: F401
from .exporter import FluxExporter  # noqa: F401

__all__ = ["FluxSpec", "FluxState", "WindowSpec", "FluxExporter"]
