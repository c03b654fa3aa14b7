"""fluentbit_tpu_torch — the PyTorch/CUDA port of fluentbit_tpu.

A second package beside ``fluentbit_tpu`` (the JAX reference, which it
never imports). Device work runs on one explicit torch device: CUDA
through hand-written kernels (``csrc/``, built with ``nvcc`` at first
use), or the CPU through their plain torch versions when the caller asks
for ``device="cpu"``.

Public embedding API mirrors the reference's library mode
(include/fluent-bit/flb_lib.h): create/input/filter/output/start/push/stop.
"""

__version__ = "0.1.0"

from .lib import FLBContext, create  # noqa: F401
