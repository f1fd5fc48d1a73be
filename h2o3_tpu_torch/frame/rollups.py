"""RollupStats' mean and sigma: a numeric column's float32 statistics.

Reference: h2o3_tpu/frame/rollups.py ``_rollup_kernel``
(water/fvec/RollupStats.java), whose mean is a float32 sum of the valid
rows over a float32 count of them (padding counts as NA) and whose sigma
is the sample deviation sqrt(ss / max(n - 1, 1)), ss the float32 sum of
squared deviations from that mean over the valid rows. The port keeps its
own copy of the statistics it uses: Extended Isolation Forest imputes
NAs with the mean, GLM's design (``frame/datainfo.py``) imputes and
standardizes with mean and sigma, and the device sort (``ops/sort.py``)
reads a key's range, and the REST frame summaries (``Frame.summary``)
read ``rollups``. One pass of torch reductions on the column's device
and one fetch.

On a frame partitioned over a sharded mesh (pass ``frame=``) the mean
and sigma are those of all the column's rows: every rank holds the whole
column's host view (the partitioned ingest gathers it), and takes the
statistic over a device copy of it at one device's padding
(``whole_column``), in one device's order. Every rank then gets one
device's numbers bit for bit, so the designs built from them
(``frame/datainfo.py``) equal one device's rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from h2o3_tpu_torch.frame.column import Column


def whole_column(col: Column, frame=None) -> Column:
    """``col`` itself, or, for a numeric column of a ``frame``
    partitioned over a sharded mesh, the column over ALL its rows on the
    rank's device, rebuilt there from its host view with one device's
    padding (``Frame.one_device_rows``): the float32 values (each the
    float64 value rounded once, as ``column_from_numpy`` rounds it) and
    the NA mask that one device holds."""
    if frame is None or not frame.partitioned:
        return col
    host = torch.from_numpy(col.host_view()).to(frame.device)
    pad = frame.one_device_rows - host.shape[0]
    na = torch.isnan(host)
    data = torch.where(na, 0.0, host).to(torch.float32)
    return Column(name=col.name, type=col.type,
                  data=torch.cat([data, data.new_zeros(pad)]),
                  na_mask=torch.cat([na, na.new_ones(pad)]),
                  nrows=col.nrows)


def _valid_f32(col: Column):
    valid = ~col.na_mask
    n = valid.to(torch.float32).sum()
    x = col.data.to(torch.float32)
    mean = torch.where(valid, x, 0.0).sum() / torch.clamp_min(n, 1.0)
    return valid, n, x, mean


def rollup_mean(col: Column, frame=None) -> float:
    """The mean of the column's valid rows, in float32 as the reference
    takes it (0.0 without a valid row); of all its rows on a partitioned
    ``frame``."""
    return float(_valid_f32(whole_column(col, frame))[3])


def rollup_mean_sigma(col: Column, frame=None) -> Tuple[float, float]:
    """(mean, sigma) of the column's valid rows in float32: sigma is the
    sample standard deviation, 0.0 with fewer than two valid rows; of
    all its rows on a partitioned ``frame``, kept in the frame's
    ``mean_sigma`` under the column's name while the frame holds that
    very column (each design of the frame takes them again)."""
    part = frame is not None and frame.partitioned
    if part:
        got = frame.mean_sigma.get(col.name)
        if got is not None and got[0] is col:
            return got[1]
    valid, n, x, mean = _valid_f32(whole_column(col, frame))
    ss = torch.where(valid, (x - mean) ** 2, 0.0).sum()
    sigma = torch.sqrt(ss / torch.clamp_min(n - 1.0, 1.0))
    m, s = torch.stack([mean, sigma]).tolist()
    if part:
        frame.mean_sigma[col.name] = (col, (m, s))
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


def rollups(col: Column) -> dict:
    """The column's RollupStats (the reference's ``rollups``): rows,
    na_count, mean, sigma, min, max, zero_count and sum of the valid
    rows in float32, computed once and cached on the column. A string or
    UUID column has ``rows`` and ``na_count`` only."""
    got = getattr(col, "_rollups", None)
    if got is not None:
        return got
    if col.data is None:
        col._rollups = {"rows": col.nrows, "na_count": 0}
        return col._rollups
    valid, n, x, mean = _valid_f32(col)
    s = torch.where(valid, x, 0.0).sum()
    ss = torch.where(valid, (x - mean) ** 2, 0.0).sum()
    sigma = torch.sqrt(ss / torch.clamp_min(n - 1.0, 1.0))
    lo = torch.where(valid, x, torch.inf).min()
    hi = torch.where(valid, x, -torch.inf).max()
    zeros = torch.where(valid, (x == 0).to(torch.float32), 0.0).sum()
    na = (~valid).sum().to(torch.float32)
    vals = torch.stack([n, na, mean, sigma, lo, hi, zeros, s]).tolist()
    out = dict(zip(("rows", "na_count", "mean", "sigma", "min", "max",
                    "zero_count", "sum"), vals))
    out["rows"] = int(out["rows"])
    out["na_count"] = int(out["na_count"]) - (col.data.shape[0] - col.nrows)
    out["zero_count"] = int(out["zero_count"])
    col._rollups = out
    return out
