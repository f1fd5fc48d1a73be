"""Column quantiles — an exact host sort, or histogram refinement on the
device.

Reference: h2o3_tpu/frame/quantiles.py (hex/quantile/Quantile.java). Up
to ``HOST_MAX_ROWS`` rows a numeric column's float64 host view is sorted
and the type-7 order statistics are read off it. Above that the device
brackets each target rank: a round takes a 1024-bin float32 histogram
of the bracket (one ``ops/segments.segment_sum``; on the card fixed
point, so counts are exact and the same on every run), the host finds
the bin holding the rank in float64 and the bracket shrinks to it. Four
rounds resolve any float32 value. The bins are computed in float32 as
the reference computes them, so both packages pick the same bins and
return the same values.

Not ported: the mesh reduction of the histogram (a frame partitioned
over a sharded mesh raises, ROADMAP A #12′).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.column import T_NUM
from h2o3_tpu_torch.ops.segments import segment_sum

NBINS = 1024
HOST_MAX_ROWS = 4_000_000


def _hist_pass(x, w, lo, hi):
    """Weighted histogram of x within [lo[q], hi[q]] for each quantile
    row q: [Q, NBINS] float32."""
    width = torch.clamp_min(hi - lo, 1e-30)
    outs = []
    for q in range(lo.shape[0]):
        # clamped before the cast: the rows outside [lo, hi] weigh 0
        b = torch.clamp((x - lo[q]) / width[q] * NBINS, 0, NBINS - 1)
        inrange = (x >= lo[q]) & (x <= hi[q])
        outs.append(segment_sum(b.to(torch.int32), (w * inrange)[:, None],
                                n_nodes=NBINS)[:, 0])
    return torch.stack(outs)


def _values_at_ranks(x0, w, ranks: np.ndarray, gmin: float, gmax: float,
                     rounds: int) -> np.ndarray:
    """The weighted order statistics at ``ranks`` (0-based) by bracket
    refinement: each round narrows [lo, hi] by NBINS."""
    Q = len(ranks)
    dev = x0.device
    lo = torch.full((Q,), gmin, dtype=torch.float32, device=dev)
    hi = torch.full((Q,), gmax, dtype=torch.float32, device=dev)
    base = np.zeros(Q)              # weight strictly below lo
    for _ in range(rounds):
        hist = _hist_pass(x0, w, lo, hi).cpu().numpy()
        lo_h = lo.cpu().numpy().astype(np.float64)
        hi_h = hi.cpu().numpy().astype(np.float64)
        width = np.maximum(hi_h - lo_h, 1e-30) / NBINS
        cum = np.cumsum(hist, axis=1)
        k = np.array([min(int(np.searchsorted(cum[q], ranks[q] - base[q],
                                              side="right")), NBINS - 1)
                      for q in range(Q)])
        below = np.where(k > 0, cum[np.arange(Q), np.maximum(k - 1, 0)], 0.0)
        lo = torch.from_numpy((lo_h + k * width).astype(np.float32)).to(dev)
        hi = torch.from_numpy((lo_h + (k + 1) * width).astype(
            np.float32)).to(dev)
        base = base + below
    return (lo.cpu().numpy().astype(np.float64)
            + hi.cpu().numpy().astype(np.float64)) / 2.0


def _combine(vlo, vhi, ranks, klo, method: str) -> np.ndarray:
    method = method.lower()
    if method == "low":
        return vlo
    if method == "high":
        return vhi
    if method in ("average", "avg", "mean"):
        return (vlo + vhi) / 2.0
    return vlo + (ranks - klo) * (vhi - vlo)        # interpolate


def column_quantiles(col, probs: Sequence[float], rounds: int = 4,
                     combine_method: str = "interpolate") -> np.ndarray:
    """Quantiles of one numeric column at ``probs``; ``combine_method``
    (interpolate, average, low or high) combines the two order
    statistics around a fractional rank."""
    probs = np.asarray(probs, np.float64)
    if col.nrows <= HOST_MAX_ROWS and col.type == T_NUM:
        host = col.to_numpy()
        v = np.sort(host[~np.isnan(host)])
        if v.size == 0:
            return np.full(len(probs), np.nan)
        ranks = probs * (v.size - 1.0)
        klo = np.floor(ranks).astype(int)
        khi = np.ceil(ranks).astype(int)
        return _combine(v[klo], v[khi], ranks, klo, combine_method)
    x = col.numeric_view()              # padding rows are NaN here
    valid = ~torch.isnan(x)
    w = valid.to(torch.float32)
    x0 = torch.where(valid, x, 0.0)
    total, gmin, gmax = torch.stack([
        w.sum(), torch.where(valid, x, torch.inf).min(),
        torch.where(valid, x, -torch.inf).max()]).tolist()
    if total == 0:
        return np.full(len(probs), np.nan)
    ranks = probs * (total - 1.0)
    klo = np.floor(ranks)
    khi = np.ceil(ranks)
    uniq = np.unique(np.concatenate([klo, khi]))
    at = dict(zip(uniq.tolist(),
                  _values_at_ranks(x0, w, uniq, gmin, gmax, rounds)))
    vlo = np.array([at[k] for k in klo])
    vhi = np.array([at[k] for k in khi])
    return _combine(vlo, vhi, ranks, klo, combine_method)


def frame_quantiles(frame, probs: Sequence[float] = (0.01, 0.1, 0.25, 0.333,
                                                     0.5, 0.667, 0.75, 0.9,
                                                     0.99),
                    combine_method: str = "interpolate"):
    """The quantile table of every numeric column (h2o.quantile)."""
    if frame.partitioned:
        raise NotImplementedError(
            "quantiles of a frame partitioned over a sharded mesh are not "
            "ported yet")
    out = {"probs": np.asarray(probs)}
    for name in frame.names:
        c = frame.col(name)
        if c.type == T_NUM:
            out[name] = column_quantiles(c, probs,
                                         combine_method=combine_method)
    return out
