"""Aggregator — exemplar-based compression of a frame.

Reference: h2o3_tpu/models/aggregator.py (hex/aggregator/Aggregator.java):
in row order, a row within ``radius`` of an exemplar joins the nearest
one, any other row becomes an exemplar; the radius grows or shrinks
until the exemplar count lands in [(1 − rel_tol)·target, target]. The
aggregated frame holds the exemplar rows, in the original space, and
their ``counts``.

A sweep takes the rows in batches of 4096: the batch's squared distances
to the exemplars so far are one float64 matrix product on the device,
and so is their argmin; the nearest exemplar and its distance come to
the host in one copy a batch. The rows beyond the radius then go through
the reference's greedy loop on the host in float64 numpy, against the
exemplars this batch has added, row by row, as in the reference (each
decision depends on the ones before it). The row norms are the host's,
so a decision differs from the reference's only where a distance equals
the radius to the last bit of the matrix product.

The aggregated frame is stored in the DKV under ``output["output_frame"]``
and ``aggregated_frame`` reads it back by that key. Not ported:
a partitioned frame (A #12′). ``categorical_encoding`` is accepted and
unread, as in the reference.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.frame.datainfo import build_datainfo
from h2o3_tpu_torch.frame.frame import Frame, raw_columns
from h2o3_tpu_torch.models.model import Model, ModelBuilder, require_local

BATCH = 4096


def _sweep(Xd: torch.Tensor, Xh: np.ndarray, x2: np.ndarray, radius: float,
           max_exemplars: int, clock: Dict[str, float]):
    """One agglomeration pass at a fixed radius: (exemplar row indices,
    counts, assignment), or Nones once the exemplars pass
    ``max_exemplars``. ``Xd`` is the float64 design on the device and
    ``Xh`` its host copy; ``clock`` gathers the device and host
    seconds."""
    n = Xh.shape[0]
    r2 = radius * radius
    ex_idx: List[int] = [0]
    assign = np.full(n, -1, dtype=np.int64)
    assign[0] = 0
    x2d = torch.from_numpy(x2).to(Xd.device)
    # the rows and norms of the exemplars a batch adds, in order
    E_new = np.empty((BATCH, Xh.shape[1]), Xh.dtype)
    x2_new = np.empty(BATCH, x2.dtype)
    for s in range(0, n, BATCH):
        t0 = time.perf_counter()
        nE = len(ex_idx)
        ex = torch.from_numpy(np.asarray(ex_idx)).to(Xd.device)
        d2 = (x2d[s:s + BATCH, None] + x2d[ex][None, :]
              - 2.0 * Xd[s:s + BATCH] @ Xd[ex].T)
        bestd, best = d2.min(1)
        got = torch.stack([best.to(torch.float64), bestd]).cpu().numpy()
        best, bestd = got[0].astype(np.int64), got[1]
        t1 = time.perf_counter()
        within = bestd <= r2
        assign[s:s + BATCH][within] = best[within]
        for i in np.flatnonzero(~within):
            gi = s + i
            if assign[gi] >= 0:
                continue
            k = len(ex_idx) - nE
            if k:
                d2n = x2[gi] + x2_new[:k] - 2.0 * E_new[:k] @ Xh[gi]
                j = d2n.argmin()
                if d2n[j] <= r2:
                    assign[gi] = nE + j
                    continue
            E_new[k] = Xh[gi]
            x2_new[k] = x2[gi]
            ex_idx.append(gi)
            assign[gi] = len(ex_idx) - 1
            if len(ex_idx) > max_exemplars:
                clock["device"] += t1 - t0
                clock["host"] += time.perf_counter() - t1
                return None, None, None
        clock["device"] += t1 - t0
        clock["host"] += time.perf_counter() - t1
    counts = np.bincount(assign, minlength=len(ex_idx))
    return np.asarray(ex_idx), counts, assign


class AggregatorModel(Model):
    algo = "aggregator"

    def __init__(self, params, output, exemplar_frame_key: str,
                 exemplar_assignment: np.ndarray):
        super().__init__(params, output)
        self.exemplar_frame_key = exemplar_frame_key
        self.exemplar_assignment = exemplar_assignment
        self.timing: Dict[str, float] = {}

    @property
    def aggregated_frame(self) -> Frame:
        return DKV.get(self.exemplar_frame_key)

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("Aggregator produces aggregated_frame")

    def model_performance(self, frame: Frame, mask_weights=None):
        return None


class AggregatorEstimator(ModelBuilder):
    """h2o-py H2OAggregatorEstimator surface."""

    algo = "aggregator"
    label = "Aggregator"

    DEFAULTS = dict(
        target_num_exemplars=5000, rel_tol_num_exemplars=0.5,
        transform="normalize", categorical_encoding="auto",
        ignored_columns=None, seed=-1,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        standardize = str(p["transform"]).lower() in ("normalize",
                                                      "standardize")
        di = build_datainfo(frame, x, standardize=standardize,
                            use_all_factor_levels=True)
        n = frame.nrows
        Xd = di.X[:n].to(torch.float64)
        Xh = Xd.cpu().numpy()
        x2 = (Xh * Xh).sum(axis=1)
        target = int(p["target_num_exemplars"])
        lo_ok = max(int(target * (1 - float(p["rel_tol_num_exemplars"]))), 1)
        clock = {"device": 0.0, "host": 0.0}
        sweeps, radius = 0, None
        if n <= target:
            ex_idx = np.arange(n)
            counts = np.ones(n, dtype=np.int64)
            assign = np.arange(n)
        else:
            # geometric radius escalation: the first radius whose
            # exemplar count falls in [lo_ok, target]
            radius = 0.05 * np.sqrt(di.P)
            ex_idx = counts = assign = None
            for _ in range(40):
                sweeps += 1
                res = _sweep(Xd, Xh, x2, radius, max(4 * target, 100), clock)
                if res[0] is not None and len(res[0]) <= target:
                    ex_idx, counts, assign = res
                    if len(ex_idx) >= lo_ok:
                        break
                    radius /= 1.5   # too few exemplars: shrink
                else:
                    radius *= 2.0   # too many: grow
            if ex_idx is None:
                sweeps += 1
                ex_idx, counts, assign = _sweep(Xd, Xh, x2, radius, n + 1,
                                                clock)
        raw = raw_columns(frame, x)
        cols = {name: raw[name][ex_idx] for name in x}
        cols["counts"] = counts.astype(np.float64)
        cats = [name for name in x if frame.col(name).is_categorical]
        agg = Frame.from_numpy(cols, categorical=cats, device=frame.device,
                               key=make_key("frame"))
        output = {"category": "Clustering", "response": None,
                  "names": list(x), "domain": None,
                  "num_exemplars": int(len(ex_idx)),
                  "sweeps": sweeps, "radius": radius,
                  "output_frame": agg.key}
        model = AggregatorModel(p, output, agg.key, assign)
        model.timing = clock
        return model
