"""Frame — a named list of device columns of one padded row count.

Reference: h2o3_tpu/frame/frame.py (``Frame.from_numpy``, ``col``,
``names``, ``nrows_padded``, ``valid_weights``). Here a plain object on
one device: no DKV key, no durability hooks, no derived-matrix caches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch.frame.column import (Column, column_from_numpy,
                                         factorize_numeric)
from h2o3_tpu_torch.parallel import device as dev_mod


class Frame:
    def __init__(self, columns: List[Column], nrows: int,
                 device: torch.device):
        self._cols: Dict[str, Column] = {c.name: c for c in columns}
        self._order: List[str] = [c.name for c in columns]
        self.nrows = nrows
        self.device = device

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   categorical: Sequence[str] = (),
                   domains: Optional[Dict[str, List[str]]] = None,
                   device: dev_mod.DeviceLike = None,
                   block: int = 8) -> "Frame":
        """Build a Frame from host columns on ``device`` (CUDA unless the
        caller names another). ``categorical`` forces listed numeric
        columns to categorical; ``domains`` supplies level lists for
        integer-coded categorical columns; string columns intern."""
        device = dev_mod.resolve_device(device)
        names = list(arrays.keys())
        n = len(next(iter(arrays.values()))) if names else 0
        npad = dev_mod.padded_rows(n, block=block)
        cols = []
        for name in names:
            v = np.asarray(arrays[name])
            dom = (domains or {}).get(name)
            if name in categorical and dom is None and \
                    v.dtype.kind not in "OUS":
                dom, v = factorize_numeric(v)
            cols.append(column_from_numpy(name, v, npad, device,
                                          domain=dom))
        return Frame(cols, n, device)

    @property
    def names(self) -> List[str]:
        return list(self._order)

    @property
    def ncols(self) -> int:
        return len(self._order)

    @property
    def nrows_padded(self) -> int:
        for c in self._cols.values():
            return c.data.shape[0]
        return self.nrows

    def col(self, name_or_idx: Union[str, int]) -> Column:
        if isinstance(name_or_idx, int):
            name_or_idx = self._order[name_or_idx]
        return self._cols[name_or_idx]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def valid_weights(self) -> torch.Tensor:
        """1.0 for logical rows, 0.0 for padding rows."""
        return dev_mod.valid_mask(self.nrows, self.nrows_padded,
                                  self.device)

    def __repr__(self) -> str:
        return (f"<Frame {self.nrows}x{self.ncols} on {self.device} "
                f"{self._order[:8]}>")
