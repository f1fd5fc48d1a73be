"""Vectorized best-split scan over a level's (node, feature, bin) histogram.

Reference: h2o3_tpu/ops/split_scan.py ``best_splits`` (itself
hex/tree/DTree.java:619-697 ``findBestSplitPoint``): cumulative {w, g, h}
over bins, Newton gain per threshold, NA-direction choice, and the
sorted-prefix categorical subset scan. The same elementwise float32
operations in the same order, so on equal histograms the two agree bit
for bit; this is also the plain version the ``tree_split`` CUDA kernel is
held against.
"""

from __future__ import annotations

import torch


def best_splits(hist, nb, col_mask, *, min_rows, reg_lambda,
                is_cat=None, constraints=None, lo=None, hi=None):
    """Best split of every node of a level.

    hist: [L, F, B, 3] of {w, g, h}; nb [F] int real bins per feature;
    col_mask [F] or [L, F] bool; ``is_cat`` [F] bool (None for an
    all-numeric scan); ``constraints`` [F] in {-1, 0, +1} with per-node
    value bounds lo/hi ([L] or [1]). Categorical bins are ordered per
    node by Newton value -g/(h+λ) (empty bins last, stable), so the best
    prefix is the best category subset. Returns per-node (gain, feat,
    thresh, na_left, left_val, right_val, leftmask [L, B-1] over ORIGINAL
    bin ids going left).
    """
    lam = reg_lambda
    L, F, B = hist.shape[0], hist.shape[1], hist.shape[2]
    dev = hist.device
    w, g, h = hist[..., 0], hist[..., 1], hist[..., 2]
    wv = w[:, :, : B - 1]
    gv = g[:, :, : B - 1]
    hv = h[:, :, : B - 1]
    order = None
    if is_cat is not None:
        # empty bins key to +inf so they sort AFTER every populated bin:
        # the t <= nb-2 threshold-validity mask then stays correct in
        # sorted space (populated bins occupy a prefix of it)
        val = torch.where(wv > 0, -gv / (hv + lam + 1e-10), torch.inf)
        pos = torch.arange(B - 1, dtype=torch.float32, device=dev)
        key = torch.where(is_cat[None, :, None], val, pos[None, None, :])
        order = torch.argsort(key, dim=2, stable=True)
        wv = torch.gather(wv, 2, order)
        gv = torch.gather(gv, 2, order)
        hv = torch.gather(hv, 2, order)
    # cumulative over (possibly re-ordered) value bins; NA bin is B-1
    cw = torch.cumsum(wv, dim=2)
    cg = torch.cumsum(gv, dim=2)
    ch = torch.cumsum(hv, dim=2)
    naw, nag, nah = w[:, :, B - 1], g[:, :, B - 1], h[:, :, B - 1]
    tw = (cw[:, :, -1] + naw)[:, :, None]
    tg = (cg[:, :, -1] + nag)[:, :, None]
    th = (ch[:, :, -1] + nah)[:, :, None]
    if lo is None:
        lo = torch.full((L,), -torch.inf, dtype=torch.float32, device=dev)
        hi = torch.full((L,), torch.inf, dtype=torch.float32, device=dev)
    lo3 = lo[:, None, None]
    hi3 = hi[:, None, None]

    def masked_gain(wl, gl, hl):
        wr = tw - wl
        gr = tg - gl
        hr = th - hl
        ok = (wl >= min_rows) & (wr >= min_rows)
        lv = torch.minimum(hi3, torch.maximum(lo3, -gl / (hl + lam)))
        rv = torch.minimum(hi3, torch.maximum(lo3, -gr / (hr + lam)))
        if constraints is not None:
            c = constraints[None, :, None].to(torch.float32)
            ok = ok & (c * (rv - lv) >= 0)
        gain = (gl * gl / (hl + lam) + gr * gr / (hr + lam)
                - tg * tg / (th + lam))
        return torch.where(ok, gain, -torch.inf), lv, rv

    g_nar, lv_nar, rv_nar = masked_gain(cw, cg, ch)         # NA → right
    g_nal, lv_nal, rv_nal = masked_gain(
        cw + naw[:, :, None], cg + nag[:, :, None],
        ch + nah[:, :, None])                               # NA → left
    # threshold validity: t <= nb[f]-2 (splitting at last real bin is void)
    t_ids = torch.arange(B - 1, dtype=torch.int32, device=dev)
    valid_t = t_ids[None, :] <= (nb.to(torch.int32)[:, None] - 2)
    cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
    mask = valid_t[None, :, :] & cm.to(torch.bool)[:, :, None]
    g_nar = torch.where(mask, g_nar, -torch.inf)
    g_nal = torch.where(mask, g_nal, -torch.inf)

    flat = torch.stack([g_nar, g_nal], dim=-1).reshape(L, -1)
    best = torch.argmax(flat, dim=1)                # first max; NaN wins
    best_gain = flat.gather(1, best[:, None])[:, 0]
    na_left = (best % 2).to(torch.bool)
    best_t = ((best // 2) % (B - 1)).to(torch.int32)
    best_f = (best // (2 * (B - 1))).to(torch.int32)
    lvals = torch.stack([lv_nar, lv_nal], dim=-1).reshape(L, -1)
    rvals = torch.stack([rv_nar, rv_nal], dim=-1).reshape(L, -1)
    best_lv = lvals.gather(1, best[:, None])[:, 0]
    best_rv = rvals.gather(1, best[:, None])[:, 0]
    if order is not None:
        # original-bin-id membership of the winning prefix: position of
        # bin b within the winning feature's order <= t  ⇔  b goes left
        order_win = order[torch.arange(L, device=dev), best_f.long()]
        ranks = torch.empty_like(order_win)
        ranks.scatter_(1, order_win,
                       torch.arange(B - 1, device=dev).expand(L, B - 1))
        leftmask = ranks <= best_t[:, None]
    else:
        leftmask = t_ids[None, :] <= best_t[:, None]
    return best_gain, best_f, best_t, na_left, best_lv, best_rv, leftmask
