"""RollupStats' mean and sigma: a numeric column's float32 statistics.

Reference: h2o3_tpu/frame/rollups.py ``_rollup_kernel``
(water/fvec/RollupStats.java), whose mean is a float32 sum of the valid
rows over a float32 count of them (padding counts as NA) and whose sigma
is the sample deviation sqrt(ss / max(n - 1, 1)), ss the float32 sum of
squared deviations from that mean over the valid rows. The port keeps its
own copy of the statistics it uses: Extended Isolation Forest imputes
NAs with the mean, GLM's design (``frame/datainfo.py``) imputes and
standardizes with mean and sigma, and the device sort (``ops/sort.py``)
reads a key's range. One pass of torch reductions on the column's
device and one fetch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from h2o3_tpu_torch.frame.column import Column


def _valid_f32(col: Column):
    valid = ~col.na_mask
    n = valid.to(torch.float32).sum()
    x = col.data.to(torch.float32)
    mean = torch.where(valid, x, 0.0).sum() / torch.clamp_min(n, 1.0)
    return valid, n, x, mean


def rollup_mean(col: Column) -> float:
    """The mean of the column's valid rows, in float32 as the reference
    takes it (0.0 without a valid row)."""
    return float(_valid_f32(col)[3])


def rollup_mean_sigma(col: Column) -> Tuple[float, float]:
    """(mean, sigma) of the column's valid rows in float32: sigma is the
    sample standard deviation, 0.0 with fewer than two valid rows."""
    valid, n, x, mean = _valid_f32(col)
    ss = torch.where(valid, (x - mean) ** 2, 0.0).sum()
    sigma = torch.sqrt(ss / torch.clamp_min(n - 1.0, 1.0))
    m, s = torch.stack([mean, sigma]).tolist()
    return m, s


def rollup_min_max(col: Column) -> Tuple[float, float]:
    """(min, max) of the column's valid rows, exact for any stored type
    ((inf, -inf) without a valid row)."""
    valid = ~col.na_mask
    x = col.data.to(torch.float64)
    lo = torch.where(valid, x, torch.inf).min()
    hi = torch.where(valid, x, -torch.inf).max()
    m, M = torch.stack([lo, hi]).tolist()
    return m, M
