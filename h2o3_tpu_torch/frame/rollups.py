"""RollupStats' mean: a numeric column's float32 mean.

Reference: h2o3_tpu/frame/rollups.py ``_rollup_kernel``
(water/fvec/RollupStats.java), whose mean is a float32 sum of the valid
rows over a float32 count of them (padding counts as NA). The port keeps
its own copy of that mean, the one statistic it uses: Extended Isolation
Forest imputes NAs with it. One pass of torch reductions on the column's
device and one fetch.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.frame.column import Column


def rollup_mean(col: Column) -> float:
    """The mean of the column's valid rows, in float32 as the reference
    takes it (0.0 without a valid row)."""
    valid = ~col.na_mask
    n = valid.to(torch.float32).sum()
    s = torch.where(valid, col.data.to(torch.float32), 0.0).sum()
    return float(s / torch.clamp_min(n, 1.0))
