"""Single-device layer — the one-card surface of the mesh module.

Reference: h2o3_tpu/parallel/mesh.py. Which device an entry point runs
on, and the one-device fetch (``.cpu().numpy()``). Row padding, the
valid-row mask and the cross-rank fetch live in ``parallel/mesh.py``,
whose world-1 mesh is this one device.

Entry points default to ``torch.device("cuda")`` and raise when no card
is present; they never move to the CPU on their own. Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none."""
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device
    and no card is present (no silent move to the CPU)."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def fetch(x: torch.Tensor) -> np.ndarray:
    """Device → host copy of a tensor as numpy."""
    return x.detach().cpu().numpy()
