"""Column — one typed device column with an NA mask and a domain.

Reference: h2o3_tpu/frame/column.py (``Column``, ``column_from_numpy``).
The port keeps only what ``Frame.from_numpy`` needs: numeric columns
(float32 on the device) and categorical columns (int32 codes plus a
host-side ``domain`` list), each with a bool NA mask. Padding rows are
marked NA. No dtype narrowing codecs, no partitioned or block
accumulators.

Every column also keeps its exact float64 host view (NaN at NA; codes for
categoricals), which the host-side paths read — the bin-edge sketch, the
response, the weights — so none of them fetches from the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

T_NUM, T_CAT = "numeric", "categorical"


@dataclasses.dataclass
class Column:
    name: str
    type: str                        # T_NUM | T_CAT
    data: torch.Tensor               # padded: float32 values | int32 codes
    na_mask: torch.Tensor            # padded bool, True = missing
    nrows: int                       # logical (unpadded) length
    domain: Optional[List[str]] = None
    host: Optional[np.ndarray] = None    # float64 [nrows], NaN at NA

    @property
    def is_categorical(self) -> bool:
        return self.type == T_CAT

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain else 0

    def numeric_view(self) -> torch.Tensor:
        """float32 view with NaN at NA positions — the math-path input."""
        return torch.where(self.na_mask, torch.nan,
                           self.data.to(torch.float32))

    def host_view(self) -> np.ndarray:
        """READ-ONLY float64 host view of the logical rows, NaN at NA."""
        return self.host

    def to_numpy(self) -> np.ndarray:
        """Owned copy of ``host_view()``."""
        return self.host.copy()


def _intern(values: np.ndarray):
    """Strings → (sorted domain, int32 codes with -1 for missing) — the
    interning of the reference parser (lexicographic domain)."""
    missing = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                        for v in values], dtype=bool)
    codes = np.full(values.shape[0], -1, np.int32)
    if (~missing).any():
        uniq, inv = np.unique(values[~missing].astype(str),
                              return_inverse=True)
        codes[~missing] = inv.astype(np.int32)
        return [str(u) for u in uniq], codes
    return [], codes


def factorize_numeric(values: np.ndarray):
    """Numeric values → (sorted domain of their string forms, int32 codes,
    -1 for NaN): a numeric column forced categorical."""
    v = np.asarray(values)
    ok = np.isfinite(v.astype(np.float64))
    codes = np.full(v.shape[0], -1, np.int32)
    uniq, inv = np.unique(v[ok], return_inverse=True)
    codes[ok] = inv.astype(np.int32)
    return [str(u) for u in uniq], codes


def column_from_numpy(name: str, values: np.ndarray, nrows_padded: int,
                      device: torch.device,
                      domain: Optional[List[str]] = None) -> Column:
    """Build a Column from host data.

    Strings intern into a sorted domain (or map through ``domain``,
    unseen and missing → NA); integer codes with a ``domain`` are
    categorical (negative or non-finite → NA); anything else is numeric,
    stored as float32 with non-finite values NA."""
    values = np.asarray(values)
    n = values.shape[0]
    pad = nrows_padded - n
    if values.dtype == object or values.dtype.kind in "US":
        if domain is None:
            domain, codes = _intern(values)
        else:
            lut = {lvl: i for i, lvl in enumerate(domain)}
            codes = np.asarray([lut.get(v, -1) if v is not None else -1
                                for v in values], np.int32)
        na = codes < 0
        data = np.where(na, 0, codes).astype(np.int32)
        ctype = T_CAT
    elif domain is not None:
        na = (values < 0) | ~np.isfinite(values.astype(np.float64))
        data = np.where(na, 0, values).astype(np.int32)
        ctype = T_CAT
    else:
        vals64 = values.astype(np.float64)
        na = ~np.isfinite(vals64)
        data = np.where(na, 0.0, vals64).astype(np.float32)
        ctype = T_NUM
    # numeric: the exact float64 input values, not their float32 copy
    host = np.where(na, np.nan,
                    vals64 if ctype == T_NUM else data.astype(np.float64))
    data_p = np.pad(data, (0, pad))
    na_p = np.pad(na, (0, pad), constant_values=True)   # padding is NA
    return Column(name=name, type=ctype,
                  data=torch.from_numpy(data_p).to(device),
                  na_mask=torch.from_numpy(na_p).to(device),
                  nrows=n, domain=domain, host=host)
