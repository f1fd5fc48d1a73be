"""Model explanation — partial dependence and permutation importance.

Reference: h2o3_tpu/ml/explain.py (water/api/PartialDependenceHandler.java,
h.partial_plot: the mean, spread and standard error of the prediction
with one column pinned to each grid value; hex/PermutationVarImp.java:
the metric's change when one feature's values are shuffled).

The reference decodes the frame's raw columns and rebuilds a frame for
every grid value and every shuffle. The port builds each of those
frames on the scored frame's device from the frame's own columns with
the one column replaced: pinned to a value, or its rows permuted by the
same ``RandomState(seed).permutation(n)`` draws in the same order (one a
feature a repeat), so the table equals the reference's on the same
model. A rebuilt categorical column's domain holds only its present
levels, the kept one all of them; scoring maps levels by label, so both
score alike.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.column import Column, column_from_numpy
from h2o3_tpu_torch.frame.frame import Frame


def _pred_column(model, frame: Frame) -> np.ndarray:
    """The prediction the PDP averages: P(class 1) for binomial, the
    numeric prediction otherwise (PartialDependenceHandler contract)."""
    out = model._score_raw(frame)
    if "p1" in out:
        return np.asarray(out["p1"], dtype=np.float64)
    return np.asarray(out["predict"], dtype=np.float64)


def _replaced(frame: Frame, col: Column) -> Frame:
    """A frame of ``frame``'s columns with ``col`` in place of its
    namesake (no key; the other columns shared)."""
    return Frame([col if n == col.name else frame.col(n)
                  for n in frame.names], frame.nrows, frame.device,
                 npad=frame.nrows_padded, block=frame.block)


def _pinned(frame: Frame, name: str, value) -> Frame:
    """``frame`` with column ``name`` holding ``value`` on every row: a
    one-level categorical, or the number."""
    c = frame.col(name)
    n, npad = frame.nrows, frame.nrows_padded
    if c.is_categorical:
        col = column_from_numpy(name, np.zeros(n, np.int32), npad,
                                frame.device, domain=[value])
    else:
        col = column_from_numpy(name, np.full(n, value, np.float64), npad,
                                frame.device)
    return _replaced(frame, col)


def _permuted(frame: Frame, name: str, perm: np.ndarray) -> Frame:
    """``frame`` with column ``name``'s rows in the order ``perm`` (a
    permutation of the logical rows; padding rows stay)."""
    c = frame.col(name)
    n = frame.nrows
    p = torch.from_numpy(perm).to(c.data.device)
    data, na = c.data.clone(), c.na_mask.clone()
    data[:n], na[:n] = c.data[p], c.na_mask[p]
    return _replaced(frame, Column(
        name=name, type=c.type, data=data, na_mask=na, nrows=n,
        domain=c.domain, host=c.host_view()[perm]))


def partial_dependence(model, frame: Frame, cols: Sequence[str],
                       nbins: int = 20) -> Dict[str, dict]:
    """Per-feature PDP tables {col: {values, mean_response,
    std_response, std_error_mean_response}}
    (PartialDependenceHandler.makePDP): a categorical's grid is its
    domain, a numeric column's the distinct values among its
    ``min(nbins, distinct)`` quantiles from 5% to 95%."""
    n = frame.nrows
    out: Dict[str, dict] = {}
    for col in cols:
        c = frame.col(col)
        if c.is_categorical:
            grid_vals: List = list(c.domain or [])
        else:
            v = c.to_numpy()
            v = v[np.isfinite(v)]
            qs = np.linspace(0.05, 0.95,
                             min(nbins, max(len(np.unique(v)), 2)))
            grid_vals = list(np.unique(np.quantile(v, qs)))
        means, stds, ses = [], [], []
        for gv in grid_vals:
            p = _pred_column(model, _pinned(frame, col, gv))[:n]
            means.append(float(np.nanmean(p)))
            stds.append(float(np.nanstd(p)))
            ses.append(float(np.nanstd(p) / np.sqrt(max(n, 1))))
        out[col] = {"values": grid_vals, "mean_response": means,
                    "std_response": stds, "std_error_mean_response": ses}
    return out


def permutation_varimp(model, frame: Frame, metric: str = "auto",
                       n_repeats: int = 1, seed: int = 0) -> List[tuple]:
    """Permutation importance rows (variable, relative, scaled,
    percentage), largest first (hex/PermutationVarImp): the mean change
    of ``metric`` (``"auto"``: logloss, else mean residual deviance,
    else MSE) over ``n_repeats`` shuffles of each feature; a drop
    counts as 0."""
    features = model.output.get("names") or []
    n = frame.nrows
    rng = np.random.RandomState(seed)

    def _metric_of(fr) -> float:
        mm_ = model.model_performance(fr)
        d = mm_.to_dict() if hasattr(mm_, "to_dict") else dict(mm_)
        if metric != "auto":
            return float(d[metric])
        for k in ("logloss", "mean_residual_deviance", "MSE"):
            if d.get(k) is not None:
                return float(d[k])
        raise ValueError("no usable metric")

    base = _metric_of(frame)
    rows = []
    for f in features:
        deltas = []
        for _ in range(max(n_repeats, 1)):
            perm = rng.permutation(n)
            deltas.append(_metric_of(_permuted(frame, f, perm)) - base)
        rows.append((f, float(np.mean(deltas))))
    vals = np.asarray([max(v, 0.0) for _, v in rows])
    vmax, vsum = max(vals.max(), 1e-12), max(vals.sum(), 1e-12)
    table = [(f, float(v), float(v / vmax), float(v / vsum))
             for (f, _), v in zip(rows, vals)]
    table.sort(key=lambda r: -r[1])
    return table
