"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda:0``.  Raises when
    a CUDA device is asked for and none is available: nothing falls back to
    the CPU, which a caller asks for by name."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available (pass device='cpu', "
                           "or --device cpu on the command line, to run on the CPU)")
    return dev


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, or anything ``np.asarray`` takes) as a tensor on
    ``device``; None means the device of a tensor ``x``, else ``cuda:0``
    (``resolve_device``)."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    device = resolve_device(device)
    return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(device)
