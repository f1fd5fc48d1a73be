"""Single-device layer — the one-card surface of the mesh module.

Reference: h2o3_tpu/parallel/mesh.py (``padded_rows``, ``valid_mask``,
``fetch_replicated``). The port runs on ONE device, so there is no mesh,
no sharding and no cross-process fetch: rows are padded to a block
multiple, padding rows carry weight 0, and a fetch is ``.cpu().numpy()``.

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


def padded_rows(n: int, block: int = 8) -> int:
    """Rows padded up to a whole number of ``block``-row blocks. Padding
    rows carry weight 0, so every weighted reduction ignores them."""
    block = max(int(block), 1)
    return ((int(n) + block - 1) // block) * block


def valid_mask(n: int, npad: int, device: torch.device) -> torch.Tensor:
    """float32 1/0 mask marking the ``n`` real rows among ``npad``."""
    m = torch.zeros(npad, dtype=torch.float32, device=device)
    m[:n] = 1.0
    return m


def fetch(x: torch.Tensor) -> np.ndarray:
    """Device → host copy of a tensor as numpy."""
    return x.detach().cpu().numpy()
