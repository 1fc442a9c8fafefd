"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

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
