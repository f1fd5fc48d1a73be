"""TreeSHAP: exact per-feature prediction contributions of a forest.

Reference: h2o3_tpu/ml/shap.py (H2O's predict_contributions; the
Lundberg & Lee path algorithm of h2o-genmodel's TreeSHAP.java). The
output has a column a feature and ``BiasTerm``; a row sums to the raw
(link-space) prediction: local accuracy.

Trees are complete binary trees (models/tree.py), so node covers pool up
from the leaves' training weights (``Tree.leaf_w``). A node that does
not split passes its rows to its left child, as scoring routes them;
where a deeper level splits them again (a DRF node whose column sample
found no split, while its child's did), the walk goes on down. The
reference ends the path there, at the leaf slot below, so for such trees
its rows do not sum to the prediction; elsewhere the two walks are the
same. As in the reference, the EXTEND/UNWIND recursion walks the tree on
the host and every path-weight update is one op over a block of rows,
here tensors on the frame's device. Two updates are taken whole where
the reference loops: EXTEND's weights in one pass over the path, and the
unwound sums of every path element of a batch of leaves of one path
length at once (leaves queue until ``LEAF_BATCH_BYTES`` of them, or the
tree, is done); each element still goes through the reference's float32
operations in its order, and the batch adds into phi by one product with
a matrix of the leaf values at the path features (another add order than
the reference's leaf by leaf). The recursion's scalars (the zero
fractions and the covers) stay on the host: a batch sends its factor
table to the device in one non-blocking copy, so nothing waits on the
device. The recursion still issues thousands of small ops a tree and
block.

Dtypes as the reference: the path weights ``W`` and ``phi`` in float32,
the leaf values, covers and the output in float64.

Row blocks: the recursion keeps a copy of ``W`` [block, D + 2] at every
depth and a one-fraction vector a path element: about ``row_bytes(D,
F)`` bytes a row at peak, so a block is ``SHAP_BLOCK_BYTES //
row_bytes(D, F)`` rows, and a leaf batch takes up to
``LEAF_BATCH_BYTES`` beside it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# device memory a row block's recursion may take at peak
SHAP_BLOCK_BYTES = 4 << 30
# device memory a batch of queued leaves may take
LEAF_BATCH_BYTES = 1 << 30


def row_bytes(D: int, F: int) -> int:
    """Peak bytes a row of the recursion: W at each of D + 2 depths
    ((D + 2)² float32), three float32 vectors a level (the go-left
    indicator and the two children's one fractions), phi and the float64
    output."""
    P = D + 2
    return 4 * P * P + 12 * (D + 1) + 4 * F + 8 * (F + 1)


class _TreeShap:
    """One tree's contributions over one row block, added into ``phi``."""

    def __init__(self, tree: Dict[str, list], bins: torch.Tensor, B: int,
                 phi: torch.Tensor, ext):
        self.h = tree                 # tree t's fields, [d][l] (_host_tree)
        self.bins = bins
        self.B = B
        self.phi = phi
        self.dev = bins.device
        self.N = bins.shape[0]
        self.D = len(tree["feat"])
        lw = tree["leaf_w"]
        # covers[d][l]: training weight reaching node (d, l)
        self.covers = [lw.reshape(1 << d, -1).sum(axis=1)
                       for d in range(self.D)] + [lw]
        self.ext = ext
        self.pending = {}             # path length -> queued leaves

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small float32 host table on the device without a wait (the
        pinned block is not reused before the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if self.dev.type != "cuda":
            return t
        return t.pin_memory().to(self.dev, non_blocking=True)

    def extend(self, ds, zs, os, W, ln, pz, po, pi):
        ds[ln], zs[ln], os[ln] = pi, pz, po
        if ln == 0:
            W[:, 0] = 1.0
            return
        a, c = self.ext[ln]
        # the reference's loop i = ln-1..0 leaves
        #   W[i+1] = W[i+1]·(pz·c_{i+1}) + (po·W[i])·a_i,  W[0] = W[0]·(pz·c_0)
        b = (c * pz).to(torch.float32)
        old = W[:, :ln]
        moved = (po[:, None] * old) * a[None, :]
        kept = old * b[None, :]
        W[:, ln] = moved[:, ln - 1]
        W[:, 1:ln] = kept[:, 1:] + moved[:, :ln - 1]
        W[:, 0] = kept[:, 0]

    def unwind(self, ds, zs, os, W, ln, i):
        """Remove path element i in place (a feature met again)."""
        o_i, z_i = os[i], zs[i]
        hot = o_i != 0
        o_safe = torch.where(hot, o_i, 1.0)
        n = W[:, ln - 1].clone()
        for j in range(ln - 2, -1, -1):
            w_hot = n * ln / ((j + 1.0) * o_safe)
            w_cold = W[:, j] * (ln / (z_i * (ln - 1.0 - j)))
            n = W[:, j] - w_hot * (z_i * (ln - 1.0 - j) / ln)
            W[:, j] = torch.where(hot, w_hot, w_cold)
        for j in range(i, ln - 1):
            ds[j], zs[j], os[j] = ds[j + 1], zs[j + 1], os[j + 1]

    def leaf(self, ds, zs, os, W, ln, v: float):
        """Queue a leaf: its path's unwound sums go into phi with the
        other leaves of its path length, a batch at a time."""
        if ln == 1:
            return
        group = self.pending.setdefault(ln, [])
        group.append((W, os[1:ln], zs[1:ln], ds[1:ln], v))
        m = ln - 1
        if len(group) * 4 * self.N * (W.shape[1] + 8 * m) >= \
                LEAF_BATCH_BYTES:
            self.flush(ln)

    def flush(self, ln: int):
        """Every path element's unwound sum at K queued leaves of path
        length ln, all at once, into phi[:, ds[i]] (i = 1..ln-1: a feature
        once on a path), the leaf value folded into the scatter."""
        group = self.pending.pop(ln, [])
        if not group:
            return
        K, m, F = len(group), ln - 1, self.phi.shape[1]
        z = np.array([g[2] for g in group], np.float64)           # [K, m]
        jj = np.arange(ln - 2, -1, -1, dtype=np.float64)[:, None, None]
        with np.errstate(divide="ignore"):
            cold = ln / (z[None] * (ln - 1.0 - jj))               # [m, K, m]
        hot_f = z[None] * (ln - 1.0 - jj) / ln
        sel = np.zeros((K, m, F), np.float64)
        for k, g in enumerate(group):
            sel[k, np.arange(m), g[3]] = g[4]
        tab = self._upload(np.concatenate(
            [cold.ravel(), hot_f.ravel(), z.ravel(), sel.ravel()]))
        cuts = np.cumsum([m * K * m, m * K * m, K * m])
        cold_t = tab[:cuts[0]].reshape(m, K, 1, m)
        hot_t = tab[cuts[0]:cuts[1]].reshape(m, K, 1, m)
        z32 = tab[cuts[1]:cuts[2]].reshape(K, 1, m)
        sel_t = tab[cuts[2]:].reshape(K * m, F)
        W = torch.stack([g[0][:, :ln] for g in group])         # [K, N, ln]
        O = torch.stack([o for g in group for o in g[1]]).reshape(
            K, m, self.N).transpose(1, 2)                      # [K, N, m]
        hot = O != 0
        o_safe = torch.where(hot, O, 1.0)
        n = W[:, :, ln - 1:ln]
        total = torch.zeros_like(O)
        for r, j in enumerate(range(ln - 2, -1, -1)):
            w_hot = n * ln / ((j + 1.0) * o_safe)
            w_cold = W[:, :, j:j + 1] * cold_t[r]
            total = total + torch.where(hot, w_hot, w_cold)
            n = W[:, :, j:j + 1] - w_hot * hot_t[r]
        contrib = (total * (O - z32)).transpose(0, 1).reshape(self.N, K * m)
        self.phi += contrib @ sel_t

    def go_left(self, d: int, l: int) -> torch.Tensor:
        """float32 [N]: 1 where a row goes left at node (d, l)."""
        h = self.h
        f = int(h["feat"][d][l])
        b = self.bins[:, f].to(torch.int32)
        if bool(h["cat_split"][d][l]):
            lw = h["left_words"][d][l]
            word = lw[(b >> 5).clamp(0, lw.shape[0] - 1).long()]
            go = ((word >> (b & 31)) & 1) == 1
        else:
            go = b <= int(h["thresh"][d][l])
        return torch.where(b == self.B - 1, bool(h["na_left"][d][l]),
                           go).to(torch.float32)

    def recurse(self, d, l, ds, zs, os, W, ln, pz, po, pi):
        h = self.h
        ds, zs, os = list(ds), list(zs), list(os)
        W = W.clone()
        self.extend(ds, zs, os, W, ln, pz, po, pi)
        ln += 1
        # a node that does not split sends its rows left, where a deeper
        # level may split them again (DRF's per-node column samples)
        while d < self.D and not h["is_split"][d][l]:
            d, l = d + 1, 2 * l
        if d == self.D:
            self.leaf(ds, zs, os, W, ln, float(h["leaf"][l]))
            return
        f = int(h["feat"][d][l])
        gl = self.go_left(d, l)
        r_j = max(float(self.covers[d][l]), 1e-30)
        r_l = float(self.covers[d + 1][2 * l])
        r_r = float(self.covers[d + 1][2 * l + 1])
        iz, io = 1.0, self.ones
        for k in range(1, ln):
            if ds[k] == f:
                iz, io = zs[k], os[k]
                self.unwind(ds, zs, os, W, ln, k)
                ln -= 1
                break
        self.recurse(d + 1, 2 * l, ds, zs, os, W, ln, iz * r_l / r_j,
                     io * gl, f)
        self.recurse(d + 1, 2 * l + 1, ds, zs, os, W, ln, iz * r_r / r_j,
                     io * (1.0 - gl), f)

    def run(self) -> float:
        """Add the tree's contributions; returns its expected value (its
        share of BiasTerm)."""
        P = self.D + 2
        self.ones = torch.ones(self.N, dtype=torch.float32, device=self.dev)
        W = torch.zeros((self.N, P), dtype=torch.float32, device=self.dev)
        self.recurse(0, 0, [0] * P, [0.0] * P, [self.ones] * P, W, 0, 1.0,
                     self.ones, -1)
        for ln in sorted(self.pending):
            self.flush(ln)
        lw, leaf = self.h["leaf_w"], self.h["leaf"]
        return float((lw * leaf).sum() / max(float(self.covers[0][0]),
                                             1e-30))


def extend_consts(n: int, device):
    """EXTEND's factors for path lengths ln = 0..n-1 on ``device``:
    (i+1)/(ln+1) as float32 and (ln-i)/(ln+1) as float64, i < ln."""
    out = []
    for ln in range(n):
        i = np.arange(ln, dtype=np.float64)
        out.append((torch.from_numpy(((i + 1.0) / (ln + 1.0)).astype(
            np.float32)).to(device),
            torch.from_numpy((ln - i) / (ln + 1.0)).to(device)))
    return out


def _host_tree(forest, t: int, scale: float) -> Dict[str, list]:
    """Tree t of a stacked forest, whatever its layout (models/tree.py):
    its split fields level by level on the host ([d][l]; ``left_words``
    stays on the device), its leaf values times ``scale`` and its leaf
    weights as float64."""
    from h2o3_tpu_torch.models.tree import _tree_at, level_arrays, \
        tree_depth
    tree = _tree_at(forest, t)
    host = type(tree)(*(a if f == "left_words" else a.cpu().numpy()
                        for f, a in zip(tree._fields, tree)))
    levels = [level_arrays(host, d) for d in range(tree_depth(tree))]
    fields = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words")
    out = {f: [lv[i] for lv in levels] for i, f in enumerate(fields)}
    out["leaf"] = host.leaf.astype(np.float64) * scale
    out["leaf_w"] = host.leaf_w.astype(np.float64)
    return out


def forest_contributions(forest, bins: torch.Tensor, B: int,
                         scale: float = 1.0, row_block=None) -> np.ndarray:
    """SHAP contributions of a stacked forest (Trees or HeapTrees) →
    float64 [N, F+1] on the host (the last column the bias). ``bins``
    [N, F] on the device the work runs on; ``scale`` multiplies every
    tree's output (1/T for DRF's averaged votes); ``row_block`` rows at
    a time (default from ``SHAP_BLOCK_BYTES``)."""
    from h2o3_tpu_torch.models.tree import tree_depth
    T, D = forest.leaf.shape[0], tree_depth(forest)
    N, F = bins.shape
    blk = int(row_block or max(1, SHAP_BLOCK_BYTES // row_bytes(D, F)))
    out = np.zeros((N, F + 1), np.float64)
    ext = extend_consts(D + 2, bins.device)
    for lo in range(0, N, blk):
        hi = min(N, lo + blk)
        phi = torch.zeros((hi - lo, F), dtype=torch.float32,
                          device=bins.device)
        bias = 0.0
        for t in range(T):
            bias += _TreeShap(_host_tree(forest, t, scale), bins[lo:hi], B,
                              phi, ext).run()
        out[lo:hi, :F] = phi.cpu().numpy()
        out[lo:hi, F] = bias
    return out


def contributions_frame(model, frame, forest=None, scale: float = 1.0,
                        bias_offset: float = 0.0):
    """GBM/DRF predict_contributions → Frame(features…, BiasTerm) on the
    frame's device. Regression and binomial models only: the reference's
    contract (hex/Model.java rejects multinomial contributions)."""
    from h2o3_tpu_torch.frame.binning import rebin_for_scoring
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.model import require_local

    cat = str(model.output.get("category"))
    if cat not in ("Regression", "Binomial"):
        raise ValueError(
            "predict_contributions supports only regression and binomial "
            f"models (got {cat})")
    require_local(frame, model.algo)
    bm = rebin_for_scoring(model.bm, frame)
    forest = forest if forest is not None else model.forest
    phi = forest_contributions(forest, bm.bins[:frame.nrows],
                               model.bm.nbins_total, scale=scale)
    phi[:, -1] += bias_offset
    cols = {n: phi[:, j] for j, n in enumerate(model.output["names"])}
    cols["BiasTerm"] = phi[:, -1]
    return Frame.from_numpy(cols, device=frame.device)
