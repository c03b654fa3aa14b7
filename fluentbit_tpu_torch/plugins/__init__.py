"""Built-in plugins of the port; importing registers them."""

from ..flux import plugin as _flux_plugin  # noqa: F401  (filter_flux)
from . import (  # noqa: F401
    filter_grep,
    filter_kubernetes,
    filter_log_to_metrics,
    filter_parser,
    filter_rewrite_tag,
    in_emitter,
    in_tail,
    inputs_basic,
    net_forward,
    net_http,
    outputs_basic,
)
