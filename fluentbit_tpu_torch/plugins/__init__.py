"""Built-in plugins of this slice; importing registers them."""

from . import filter_grep, inputs_basic, outputs_basic  # noqa: F401
