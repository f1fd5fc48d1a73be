"""Segment models — train one model per segment of a frame.

Reference: h2o3_tpu/ml/segments.py (hex/segments/SegmentModels.java,
SegmentModelsBuilder): ``train_segments`` splits the frame by the
distinct values of ``segment_columns``, trains the same algorithm and
parameters on each segment's rows, and collects each segment's model key,
status and error into a results frame.

The segments come in the reference's order (sorted by the values' text)
and a segment whose fit fails is recorded as FAILED with its error, not
raised. The rows of each segment are found from one ``np.unique`` over
the segment columns' codes, where the reference compares every row's
tuple with every segment's; the frames are the same. A segment's frame is
built on the training frame's device. With ``parallelism`` > 1 the
segments train on that many threads, each pointed at the frame's CUDA
device (``core/job.py``'s rule). A numeric segment column's NaN rows form
one segment (the reference's tuples make each NaN row a segment of its
own).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.job import _thread_device
from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.frame.frame import Frame, raw_columns

log = logging.getLogger("h2o3_tpu_torch.segments")


class SegmentModels:
    """Per-segment training results (hex/segments/SegmentModels.java),
    stored in the DKV under ``key``."""

    def __init__(self, key: str, segment_columns: List[str],
                 results: List[dict], device=None):
        self.key = key
        self.segment_columns = segment_columns
        self.results = results
        self.device = device
        DKV.put(key, self)

    def as_frame(self) -> Frame:
        """One row a segment: its segment values, model key, status and
        errors, every column categorical."""
        cols: Dict[str, np.ndarray] = {}
        for sc in self.segment_columns:
            cols[sc] = np.asarray([r["segment"][sc] for r in self.results],
                                  dtype=object)
        cols["model"] = np.asarray(
            [r.get("model_key") or "" for r in self.results], dtype=object)
        cols["status"] = np.asarray([r["status"] for r in self.results],
                                    dtype=object)
        cols["errors"] = np.asarray([r.get("error") or ""
                                     for r in self.results], dtype=object)
        return Frame.from_numpy(cols, categorical=list(cols),
                                device=self.device)


def _segment_ids(frame: Frame, raw: Dict[str, np.ndarray],
                 seg_cols: List[str]):
    """(each row's segment number, each segment's first row), segments
    numbered in the reference's order: by the text of their values."""
    n = frame.nrows
    codes = []
    for sc in seg_cols:
        c = frame.col(sc)
        if c.is_categorical:
            v = np.nan_to_num(c.host_view()[:n], nan=-1.0)
        else:
            v = raw[sc][:n].astype(np.float64)
        codes.append(np.unique(v, return_inverse=True)[1].reshape(n))
    combos, first, inv = np.unique(np.stack(codes, axis=1), axis=0,
                                   return_index=True, return_inverse=True)
    text = [tuple(str(raw[sc][r]) for sc in seg_cols) for r in first]
    order = sorted(range(len(combos)), key=lambda i: text[i])
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(n)], first[order]


def train_segments(builder_cls, params: dict, frame: Frame,
                   segment_columns: Sequence[str], y: Optional[str] = None,
                   x: Optional[Sequence[str]] = None,
                   parallelism: int = 1) -> SegmentModels:
    """The SegmentModelsBuilder.buildSegmentModels flow: find the distinct
    segment tuples, take each one's rows, train one model on them. A
    failure is recorded in its segment's entry, not raised."""
    seg_cols = list(segment_columns)
    raw = raw_columns(frame, frame.names)
    n = frame.nrows
    seg_of_row, first = _segment_ids(frame, raw, seg_cols)
    cats = [nm for nm in frame.names if frame.col(nm).is_categorical]
    keep_cats = [c for c in cats if c not in seg_cols]
    cuda_dev = _thread_device(frame.device)

    def _train_one(s: int) -> dict:
        mask = seg_of_row == s
        entry = {"segment": {sc: str(raw[sc][first[s]]) for sc in seg_cols}}
        try:
            if cuda_dev is not None:
                torch.cuda.set_device(cuda_dev)
            sub = Frame.from_numpy(
                {nm: raw[nm][:n][mask] for nm in frame.names
                 if nm not in seg_cols},
                categorical=keep_cats, device=frame.device)
            model = builder_cls(**params).train(sub, y=y, x=x)
            entry["status"] = "SUCCEEDED"
            entry["model_key"] = model.key
        except Exception as e:   # noqa: BLE001 - a segment's failure is kept
            entry["status"] = "FAILED"
            entry["error"] = str(e)
            log.warning("segment %s failed: %s", entry["segment"], e)
        return entry

    segs = range(len(first))
    if parallelism > 1:
        with ThreadPoolExecutor(max_workers=int(parallelism)) as pool:
            results = list(pool.map(_train_one, segs))
    else:
        results = [_train_one(s) for s in segs]
    return SegmentModels(make_key("segment_models"), seg_cols, results,
                         device=frame.device)
