"""Device sort and join index for the Rapids munging surface.

Reference: h2o3_tpu/ops/sort.py (water/rapids/RadixOrder.java and
BinaryMerge.java). A frame sorts by its key columns as one stable
``torch.sort`` a key, minor key to major key, on the frame's device (NA
keys last, padding rows after every valid row), and the columns are
gathered by the permutation. A join sorts the right keys once and
binary-searches every left key (``torch.searchsorted``); the host only
expands the match ranges. Frames under ``DEVICE_SORT_MIN_ROWS`` rows,
with a string column, or with a key that does not survive a float32
cast, return None: the caller takes the host path.

Not ported: a frame partitioned over a sharded mesh (ROADMAP A #12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.rollups import rollup_min_max

# below this many rows the host path wins
DEVICE_SORT_MIN_ROWS = 65536


def _lexsort_device(keys, nas, valid_n: int) -> torch.Tensor:
    """Stable ascending lexsort, ``keys[0]`` the primary key: the
    [Npad] int64 permutation, NA keys after the valid ones and padding
    rows (index >= ``valid_n``) at the very end."""
    N = keys[0].shape[0]
    order = torch.arange(N, device=keys[0].device)
    for k, na in zip(reversed(keys), reversed(nas)):
        kk = torch.where(na, torch.inf, k)[order]
        order = order[torch.sort(kk, stable=True).indices]
    pad = (order >= valid_n).to(torch.int32)
    return order[torch.sort(pad, stable=True).indices]


def _f32_safe(c) -> bool:
    """True when the column's values survive a float32 cast exactly, so
    the device order is the float64 host order. A column of integers
    (stored as integers by the reference, whose sort casts them) is
    safe only within ±2^24; a float column is stored float32 in both
    packages."""
    if c.data is None:
        return False
    if c.data.dtype in (torch.int8, torch.int16, torch.uint8):
        return True
    if c.data.is_floating_point():
        h = c.host_view()
        h = h[~np.isnan(h)]
        if not (np.all(h == np.round(h)) and np.all(np.abs(h) < 2 ** 31)):
            return True
    lo, hi = rollup_min_max(c)
    return max(abs(lo), abs(hi)) < 2 ** 24


def device_sort(frame: Frame, key_names: List[str],
                ascending: List[bool]) -> Optional[Frame]:
    """``frame`` sorted by its key columns on its device (a descending
    key sorts as its negation, NAs still last), or None when the frame
    takes the host path."""
    if frame.partitioned:
        raise NotImplementedError(
            "sorting a frame partitioned over a sharded mesh is not "
            "ported yet")
    if frame.nrows < DEVICE_SORT_MIN_ROWS:
        return None
    cols = [frame.col(n) for n in frame.names]
    if any(c.data is None for c in cols):
        return None                       # string/uuid columns → host
    if not all(_f32_safe(frame.col(n)) for n in key_names):
        return None
    keys, nas = [], []
    for n, asc in zip(key_names, ascending):
        c = frame.col(n)
        v = c.data.to(torch.float32)
        keys.append(v if asc else -v)
        nas.append(c.na_mask)
    order = _lexsort_device(keys, nas, frame.nrows)
    rows = order[:frame.nrows].cpu().numpy()
    new_cols = [dataclasses.replace(c, data=c.data[order],
                                    na_mask=c.na_mask[order],
                                    host=c.host[rows]) for c in cols]
    return Frame(new_cols, frame.nrows, frame.device,
                 npad=frame.nrows_padded, block=frame.block)


def _join_core(l_key, r_key, l_valid: int, r_valid: int):
    """Sort the right keys; the [lo, hi) run of each left key among
    them (float32 keys, NaN as +inf)."""
    def clean(k):
        k = k.to(torch.float32)
        return torch.where(torch.isnan(k), torch.inf, k)
    lk, rk = clean(l_key[:l_valid]), clean(r_key[:r_valid])
    r_sorted, r_order = torch.sort(rk, stable=True)
    lo = torch.searchsorted(r_sorted, lk, side="left")
    hi = torch.searchsorted(r_sorted, lk, side="right")
    return r_order, lo, hi, torch.isinf(lk)


def device_join_index(l_key: torch.Tensor, r_key: torch.Tensor,
                      l_valid: int, r_valid: int):
    """Single-key equi-join indices: host arrays (l_idx, r_idx) of the
    matching row pairs, left rows in order and each one's matches in
    the stable order of the sorted right keys (the inner-join core)."""
    r_order, lo, hi, nan_l = (t.cpu().numpy() for t in _join_core(
        l_key, r_key, l_valid, r_valid))
    cnt = np.where(nan_l, 0, hi - lo)
    l_idx = np.repeat(np.arange(l_valid), cnt)
    starts = np.repeat(lo, cnt)
    within = np.arange(cnt.sum()) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    return l_idx, r_order[starts + within].astype(np.int32)
