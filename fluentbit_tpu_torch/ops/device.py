"""The explicit torch device the port's device work runs on.

The port's counterpart of ``fluentbit_tpu/ops/device.py``. There is no
attach thread and no CPU fallback: a pipeline names its device when it is
created (``cuda`` unless the caller asks for ``cpu``), and asking for CUDA
where there is none raises.

A device error has a class of its own, :class:`DeviceError`: a failed
kernel build and a launch that returns an error code raise it, and so
does the failpoint site ``device.dispatch`` at a launch wrapper's
boundary. ``DEVICE_ERRORS`` adds torch's own accelerator and
out-of-memory errors. The engine counts each under its lane
(``fluentbit_device_launch_failures_total{lane}``) and re-raises it: the
host error policy, which logs a filter's error and passes its records
on, never takes one.
"""

from __future__ import annotations

from typing import Tuple, Type, Union

import numpy as np
import torch

from .. import failpoints as _fp

DeviceLike = Union[str, torch.device, None]
ArrayLike = Union[np.ndarray, torch.Tensor]


class DeviceError(RuntimeError):
    """A kernel that did not build, or a launch that failed. ``lane``
    names the device plane it belongs to: ``grep`` (the DFA matchers)
    or ``flux`` (the sketch and window kernels)."""

    def __init__(self, message: str, lane: str = "grep"):
        super().__init__(message)
        self.lane = lane


#: every exception the port treats as a device error
DEVICE_ERRORS: Tuple[Type[BaseException], ...] = (DeviceError,) + tuple(
    getattr(torch, name) for name in ("AcceleratorError", "OutOfMemoryError")
    if isinstance(getattr(torch, name, None), type))


def dispatch_point(lane: str) -> None:
    """The failpoint site ``device.dispatch``, after a launch (on the
    plain route too): armed with ``return``, it raises
    :class:`DeviceError` as a launch returning an error would."""
    if _fp.ACTIVE:
        try:
            _fp.fire("device.dispatch")
        except _fp.FailpointError as e:
            raise DeviceError(f"{lane} launch failed: {e}",
                              lane=lane) from e


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
