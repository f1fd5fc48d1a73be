"""Device sort-merge equi-join — the BinaryMerge.java role on the card.

Reference: h2o3_tpu/ops/merge.py (water/rapids/RadixOrder.java and
BinaryMerge.java). ``device_merge`` joins two frames on their key
columns on the left frame's device:

1. the left and the right keys, concatenated, sort as one (a stable
   ``torch.sort`` a key, minor key to major, then one that moves NA keys
   behind every valid key); equal key tuples form runs, and each left
   row's matches are the right rows of its run: a range into the right
   rows' sorted order, which falls out of the same sort;
2. the match total is the one number the host reads (it sizes the
   output); the expansion of the ranges (``repeat_interleave``) and the
   gathers of every output column stay on the device.

Left rows come out in order, each one's matches in right-row order; NA
keys never match; in a left join a row without a match appears once,
its right columns NA. Each key compares in the type the reference
stores it in: integer values (every value integral and below 2^31 in
magnitude, on both sides) as int32, so keys above 2^24 stay exact, any
other numbers as float32, categorical codes as int32 with the right
codes remapped into the left domain (a level the left frame lacks is
NA). Multi-key equality compares each key in its own type.

``device_merge`` returns None where the reference takes its host path:
right and outer joins, no keys, frames under ``DEVICE_MERGE_MIN_ROWS``
rows, string or uuid columns, a categorical key against a numeric one,
a domain of 2^24 levels or more, and a result over the output budget
(``_merge_out_budget``).

The output frame's host views are read from the device when first asked
for (``Column.host_view``), not by the merge. Not ported: a frame
partitioned over a sharded mesh (ROADMAP A #12′).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.frame.column import Column
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.parallel import mesh as mesh_mod
from h2o3_tpu_torch.parallel.device import fetch

DEVICE_MERGE_MIN_ROWS = 65536
_F32_EXACT = 2 ** 24


def _merge_out_budget(device: torch.device) -> int:
    """Bytes the join result may take on ``device``: the
    ``H2O3TPU_MERGE_MAX_OUT_BYTES`` variable, else half the card's
    memory (``torch.cuda.mem_get_info``'s total), else 2 GB on the
    CPU."""
    env = os.environ.get("H2O3TPU_MERGE_MAX_OUT_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1] * 0.5)
    return 2 << 30


def _int_stored(c: Column):
    """(stored as integers by the reference, some |value| >= 2^24) of a
    numeric column, from its float64 host view: the reference narrows a
    column to an integer type when every valid value is integral and
    below 2^31 in magnitude."""
    h = c.host_view()
    h = h[~np.isnan(h)]
    mag = np.abs(h)
    is_int = bool(np.all(h == np.round(h)) and np.all(mag < 2 ** 31))
    return is_int, bool(h.size and mag.max() >= _F32_EXACT)


def _int_keys(c: Column, big: bool) -> torch.Tensor:
    """The int32 keys of an integer-valued column's rows: from the
    float32 device data when it is exact (every |value| < 2^24), else
    from the exact host view."""
    if not big:
        return c.data[:c.nrows].to(torch.int32)
    h = np.nan_to_num(c.host_view(), nan=0.0)
    return torch.from_numpy(h.astype(np.int32)).to(c.data.device)


def _key_pair(lc: Column, rc: Column):
    """(left keys, left NA, right keys, right NA) over the logical rows,
    in the type the reference compares them in; None where the
    reference's device path declines."""
    if lc.data is None or rc.data is None:
        return None
    if lc.is_categorical != rc.is_categorical:
        return None
    nl, nr = lc.nrows, rc.nrows
    lna, rna = lc.na_mask[:nl], rc.na_mask[:nr]
    if lc.is_categorical:
        ldom, rdom = lc.domain or [], rc.domain or []
        if max(len(ldom), len(rdom)) >= _F32_EXACT:
            return None
        lk, rk = lc.data[:nl], rc.data[:nr]
        if ldom != rdom:
            lut = {lvl: i for i, lvl in enumerate(ldom)}
            mp = torch.tensor([lut.get(lvl, -1) for lvl in rdom] or [-1],
                              dtype=torch.int32, device=rk.device)
            rk = mp[rk.long()]
            rna = rna | (rk < 0)          # a level the left lacks: NA
        return lk, lna, rk, rna
    (l_int, l_big), (r_int, r_big) = _int_stored(lc), _int_stored(rc)
    if l_int and r_int:
        return _int_keys(lc, l_big), lna, _int_keys(rc, r_big), rna
    return lc.data[:nl].float(), lna, rc.data[:nr].float(), rna


def _match_ranges(l_keys, l_nas, r_keys, r_nas):
    """Per left row: the first position of its matches in the right
    rows' sorted order and their count; and that order (right row
    indices). One sort of the concatenated keys; NA keys never match."""
    L, R = l_keys[0].shape[0], r_keys[0].shape[0]
    N = L + R
    dev = l_keys[0].device
    na = torch.cat([torch.stack(l_nas).any(0), torch.stack(r_nas).any(0)])
    comb = [torch.where(na, torch.zeros((), dtype=lk.dtype, device=dev),
                        torch.cat([lk, rk.to(lk.dtype)]))
            for lk, rk in zip(l_keys, r_keys)]
    order = torch.arange(N, device=dev)
    for k in reversed(comb):
        order = order[torch.sort(k[order], stable=True).indices]
    s_na = na[order]
    order = order[torch.sort(s_na.to(torch.uint8), stable=True).indices]
    s_na = na[order]
    s_side = (order >= L).to(torch.int64)          # 1 on a right row
    new_run = torch.zeros(N, dtype=torch.bool, device=dev)
    new_run[0] = True
    for k in comb:
        sk = k[order]
        new_run[1:] |= sk[1:] != sk[:-1]
    new_run[1:] |= s_na[1:] != s_na[:-1]
    run_id = torch.cumsum(new_run, 0) - 1
    run_rights = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, run_id, s_side)
    cnt_at = torch.where(s_na, 0, run_rights[run_id])
    rights_before = torch.cumsum(s_side, 0) - s_side
    pos = torch.arange(N, device=dev)
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    lo_at = rights_before[run_start]
    # a left row's combined index is its row; right rows go to slot L
    is_left = s_side == 0
    slot = torch.where(is_left, order, L)
    lo = torch.zeros(L + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, lo_at)[:L]
    cnt = torch.zeros(L + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, cnt_at)[:L]
    # the right row at combined position p has sorted rank rights_before
    rank = torch.where(is_left, R, rights_before)
    r_order = torch.zeros(R + 1, dtype=torch.int64, device=dev).scatter_(
        0, rank, torch.where(is_left, 0, order - L))[:R]
    return lo, cnt, r_order


def _host_thunk(c: Column, data, mask, n, idx):
    """The host view of ``c``'s rows gathered at ``idx`` (``data`` and
    ``mask`` on the device), computed when first asked for: NaN at NA;
    else the source's exact host values where the reference keeps the
    column as integers and float32 does not hold them (|value| >= 2^24),
    else the gathered device data."""
    def host():
        na = fetch(mask[:n])
        big = not c.is_categorical and all(_int_stored(c))
        v = (c.host_view()[fetch(idx)] if big
             else fetch(data[:n]).astype(np.float64))
        return np.where(na, np.nan, v)
    return host


def _gathered(c: Column, idx, extra_na, total, npad, name):
    """``c``'s rows at ``idx`` (NA also where ``extra_na``), padded to
    ``npad`` rows (padding NA), as a Column named ``name``."""
    pad = npad - total
    na = c.na_mask[idx]
    if extra_na is not None:
        na = na | extra_na
    data = torch.where(na, torch.zeros((), dtype=c.data.dtype,
                                       device=c.data.device), c.data[idx])
    data = torch.nn.functional.pad(data, (0, pad))
    na = torch.nn.functional.pad(na, (0, pad), value=True)
    return Column(name=name, type=c.type, data=data, na_mask=na,
                  nrows=total, domain=c.domain,
                  host_fn=_host_thunk(c, data, na, total, idx))


def device_merge(lf: Frame, rf: Frame, key_names: List[str],
                 how: str) -> Optional[Frame]:
    """Multi-key equi-join of ``lf`` and ``rf`` on ``key_names`` (``how``
    "inner" or "left") on the frames' device: the left columns (``_x``
    on a name the right frame shares), then the right non-key columns
    (``_y``); None where the reference takes its host path."""
    if how not in ("inner", "left"):
        return None
    if not key_names:
        return None
    if max(lf.nrows, rf.nrows) < DEVICE_MERGE_MIN_ROWS:
        return None
    if lf.nrows == 0 or rf.nrows == 0:
        return None
    if lf.partitioned or rf.partitioned:
        raise NotImplementedError(
            "merging frames partitioned over a sharded mesh is not ported "
            "yet")
    pairs = [_key_pair(lf.col(k), rf.col(k)) for k in key_names]
    if any(p is None for p in pairs):
        return None
    keys = set(key_names)
    l_cols = [lf.col(n) for n in lf.names]
    r_cols = [rf.col(n) for n in rf.names if n not in keys]
    if any(c.data is None for c in l_cols + r_cols):
        return None                      # string/uuid columns → host
    lo, cnt, r_order = _match_ranges(*(list(t) for t in zip(*pairs)))
    cnt_out = cnt.clamp_min(1) if how == "left" else cnt
    total = int(cnt_out.sum())           # the one number the host reads
    if total == 0:
        return _empty_like(lf, rf, key_names)
    # an oversized result (a low-cardinality key makes a join quadratic)
    # goes to the host path before anything is allocated for it
    out_cells = total * (len(l_cols) + len(r_cols))
    if out_cells * 9 > _merge_out_budget(lf.device):   # 8B data + 1B mask
        return None
    dev = lo.device
    L = cnt.shape[0]
    li = torch.repeat_interleave(torch.arange(L, device=dev), cnt_out,
                                 output_size=total)
    offs = torch.cumsum(cnt_out, 0) - cnt_out
    within = torch.arange(total, device=dev) - offs[li]
    unmatched = within >= cnt[li]
    ri = r_order[torch.clamp(lo[li] + within, max=r_order.shape[0] - 1)]
    npad = mesh_mod.padded_rows(total, mesh_mod.LOCAL, 8)
    collide = {c.name for c in r_cols if c.name in set(lf.names)}
    new_cols = [_gathered(c, li, None, total, npad,
                          c.name + "_x" if c.name in collide else c.name)
                for c in l_cols]
    new_cols += [_gathered(c, ri, unmatched, total, npad,
                           c.name + "_y" if c.name in collide else c.name)
                 for c in r_cols]
    return Frame(new_cols, total, lf.device, npad=npad, block=8)


def _empty_like(lf: Frame, rf: Frame, key_names: List[str]) -> Frame:
    """The zero-row result of a join with no match, on the left frame's
    device."""
    arrays, cats, doms = {}, [], {}
    keys = set(key_names)
    collide = {n for n in rf.names if n not in keys and n in set(lf.names)}
    for side, names, suffix in ((lf, lf.names, "_x"),
                                (rf, [n for n in rf.names if n not in keys],
                                 "_y")):
        for n in names:
            c = side.col(n)
            nm = n + suffix if n in collide else n
            if c.is_categorical:
                arrays[nm] = np.zeros(0, np.int32)
                cats.append(nm)
                doms[nm] = c.domain
            else:
                arrays[nm] = np.zeros(0, np.float64)
    return Frame.from_numpy(arrays, categorical=cats, domains=doms,
                            device=lf.device)
