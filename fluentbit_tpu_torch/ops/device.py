"""The explicit torch device the port's device work runs on.

The port's counterpart of ``fluentbit_tpu/ops/device.py``. There is no
attach thread and no CPU fallback: a pipeline names its device when it is
created (``cuda`` unless the caller asks for ``cpu``), and asking for CUDA
where there is none raises.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]
ArrayLike = Union[np.ndarray, torch.Tensor]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``. Raises RuntimeError when CUDA is asked for
    and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fluentbit_tpu_torch: CUDA device requested but "
                "torch.cuda.is_available() is false (pass device='cpu' "
                "to run the plain torch path on the host)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x: ArrayLike, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A staged host array (numpy or tensor) of ``dtype`` on ``device``,
    contiguous: one non-blocking copy (asynchronous from pinned memory).
    Raises ValueError on another dtype."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if x.dtype != dtype:
        raise ValueError(f"expected {dtype}, got {x.dtype}")
    return x.to(device, non_blocking=True).contiguous()


def describe(device: torch.device) -> dict:
    """Platform, device count and name of a resolved device."""
    if device.type == "cuda":
        return {"platform": "gpu", "count": torch.cuda.device_count(),
                "kind": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "count": 1, "kind": "cpu"}
