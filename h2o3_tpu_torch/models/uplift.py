"""Uplift DRF — treatment-effect random forests.

Reference: h2o3_tpu/models/uplift.py (hex/tree/uplift/UpliftDRF.java): a
binomial response plus a 2-level treatment column; the split criterion
maximizes the divergence gain between the treated and control response
distributions (KL / Euclidean / ChiSquared), leaves predict
``uplift = P(y=1|treated) - P(y=1|control)``; the metrics are AUUC/Qini.

Per level the (node, feature, bin) stats come from TWO calls of
``ops.histogram.histogram`` — treated-masked and control-masked weights,
{count, positives} each, every node summed (no sibling subtraction): on
the card that is the ``histogram`` CUDA kernel. The divergence scan and
the row routing are plain torch ops on the device, with no host sync in
a tree.

Random numbers: each tree draws its bag and its per-node column samples
from a ``torch.Generator`` seeded from (seed, tree index), as GBM does.
The draws differ from the reference's ``jax.random`` bits.

Data-parallel fit: on a frame partitioned over a sharded mesh every rank
grows the trees on its own rows, its bag drawn as one device draws it
(``Frame.uniform_rows``); each level's two histograms sum the rank's
rows and all-reduce their int64 cells, the leaf sums likewise, so every
rank grows one device's forest bit for bit. AUUC and Qini come from the
scores gathered over the ranks (``fetch_replicated``): one device's
numbers on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import (BinnedMatrix, bin_frame,
                                          rebin_for_scoring)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.gbm import tree_generator
from h2o3_tpu_torch.models.model import Model, ModelBuilder, adapt_domain
from h2o3_tpu_torch.models.tree import (Tree, _mtries_mask, predict_forest,
                                        row_feature_values, stack_trees,
                                        zero_catsplit)
from h2o3_tpu_torch.ops.histogram import histogram, stat_exponents
from h2o3_tpu_torch.ops.segments import segment_sum
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.mesh import fetch_replicated


def _smooth_p(pos, n):
    return (pos + 1.0) / (n + 2.0)   # Laplace-smoothed response rate


def _divergence(pt, pc, metric: str):
    if metric == "euclidean":
        return 2.0 * (pt - pc) ** 2
    if metric == "chi_squared":
        pc_ = torch.clamp(pc, 1e-7, 1 - 1e-7)
        return (pt - pc) ** 2 / pc_ + (pt - pc) ** 2 / (1 - pc_)
    # KL (reference default)
    pt_ = torch.clamp(pt, 1e-7, 1 - 1e-7)
    pc_ = torch.clamp(pc, 1e-7, 1 - 1e-7)
    return (pt_ * torch.log(pt_ / pc_)
            + (1 - pt_) * torch.log((1 - pt_) / (1 - pc_)))


def _best_uplift_splits(ht, hc, nb, col_mask, min_rows: float, metric: str):
    """Divergence-gain scan over (node, feature, bin, NA direction).

    ht/hc: [L, F, B, 3] {count, positives, _} for treatment / control;
    ``col_mask`` [F] or [L, F] bool. Returns per-node (gain, feat,
    thresh, na_left); the argmax keeps the first maximum."""
    B = ht.shape[2]
    nt, yt = ht[..., 0], ht[..., 1]
    nc, yc = hc[..., 0], hc[..., 1]
    cnt_t = torch.cumsum(nt[:, :, : B - 1], dim=2)
    cyt = torch.cumsum(yt[:, :, : B - 1], dim=2)
    cnt_c = torch.cumsum(nc[:, :, : B - 1], dim=2)
    cyc = torch.cumsum(yc[:, :, : B - 1], dim=2)
    na = (nt[:, :, B - 1], yt[:, :, B - 1], nc[:, :, B - 1], yc[:, :, B - 1])
    tot_t = cnt_t[:, :, -1] + na[0]
    tot_yt = cyt[:, :, -1] + na[1]
    tot_c = cnt_c[:, :, -1] + na[2]
    tot_yc = cyc[:, :, -1] + na[3]
    d_node = _divergence(_smooth_p(tot_yt, tot_t),
                         _smooth_p(tot_yc, tot_c), metric)
    n_all = tot_t + tot_c

    def gain_of(lt, lyt, lc, lyc):
        rt = tot_t[:, :, None] - lt
        ryt = tot_yt[:, :, None] - lyt
        rc = tot_c[:, :, None] - lc
        ryc = tot_yc[:, :, None] - lyc
        nl, nr = lt + lc, rt + rc
        dl = _divergence(_smooth_p(lyt, lt), _smooth_p(lyc, lc), metric)
        dr = _divergence(_smooth_p(ryt, rt), _smooth_p(ryc, rc), metric)
        g = (nl * dl + nr * dr) / torch.clamp_min(n_all[:, :, None], 1.0) \
            - d_node[:, :, None]
        ok = (nl >= min_rows) & (nr >= min_rows) & (lt > 0) & (lc > 0) \
            & (rt > 0) & (rc > 0)
        return torch.where(ok, g, -torch.inf)

    g_nar = gain_of(cnt_t, cyt, cnt_c, cyc)
    g_nal = gain_of(cnt_t + na[0][:, :, None], cyt + na[1][:, :, None],
                    cnt_c + na[2][:, :, None], cyc + na[3][:, :, None])
    t_ids = torch.arange(B - 1, dtype=torch.int32, device=ht.device)
    valid_t = t_ids[None, :] <= (nb.to(torch.int32)[:, None] - 2)
    cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
    mask = valid_t[None, :, :] & cm[:, :, None]
    g_nar = torch.where(mask, g_nar, -torch.inf)
    g_nal = torch.where(mask, g_nal, -torch.inf)
    L = ht.shape[0]
    flat = torch.stack([g_nar, g_nal], dim=-1).reshape(L, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    na_left = (best % 2).to(torch.bool)
    best_t = ((best // 2) % (B - 1)).to(torch.int32)
    best_f = (best // (2 * (B - 1))).to(torch.int32)
    return best_gain, best_f, best_t, na_left


def _grow_uplift_tree(bins, nb, w, y, treat, gen: Optional[torch.Generator],
                      *, depth: int, B: int, mtries: int, metric: str,
                      min_rows: float = 10.0,
                      hist_fn: Callable = histogram, mesh=None):
    """One uplift tree on the device; returns (Tree with leaf = uplift,
    per-leaf treated response rate, per-leaf control response rate).

    ``0 < mtries < F`` samples exactly ``mtries`` columns per node per
    level from ``gen``. ``hist_fn`` is ``histogram`` (the kernel on CUDA
    tensors) or ``plain_histogram`` (the plain version, for holding one
    against the other; one device only). On a sharded ``mesh`` the rows
    are this rank's; the histograms and leaf sums cover every rank's."""
    dev = bins.device
    N, F = bins.shape
    Lmax = 2 ** (depth - 1) if depth > 0 else 1
    nid = torch.zeros((N,), dtype=torch.int32, device=dev)
    wt = w * treat
    wc = w * (1.0 - treat)
    feats = torch.zeros((depth, Lmax), dtype=torch.int32, device=dev)
    threshs = torch.full((depth, Lmax), B, dtype=torch.int32, device=dev)
    na_lefts = torch.zeros((depth, Lmax), dtype=torch.bool, device=dev)
    is_splits = torch.zeros((depth, Lmax), dtype=torch.bool, device=dev)
    ones = torch.ones_like(y)
    all_cols = torch.ones((1, F), dtype=torch.bool, device=dev)
    # each arm's stats are the tree's: their exponents once a tree
    et = stat_exponents(wt, y, ones, mesh=mesh)
    ec = stat_exponents(wc, y, ones, mesh=mesh)
    hkw = {} if mesh is None else {"mesh": mesh}
    for d in range(depth):
        L = 2 ** d
        ht = hist_fn(bins, nid, wt, y, ones, n_nodes=L, n_bins=B, exps=et,
                     **hkw)
        hc = hist_fn(bins, nid, wc, y, ones, n_nodes=L, n_bins=B, exps=ec,
                     **hkw)
        cm = (_mtries_mask(gen, L, F, mtries, dev) if 0 < mtries < F
              else all_cols)
        bg, bf, bt, bnal = _best_uplift_splits(ht, hc, nb, cm, min_rows,
                                               metric)
        split = bg > 1e-9
        feats[d, :L] = torch.where(split, bf, 0)
        threshs[d, :L] = torch.where(split, bt, B)
        na_lefts[d, :L] = split & bnal
        is_splits[d, :L] = split
        n = nid.long()
        b_r = row_feature_values(bins, feats[d][n])
        isna = b_r == (B - 1)
        goleft = torch.where(is_splits[d][n],
                             torch.where(isna, na_lefts[d][n],
                                         b_r <= threshs[d][n]), True)
        nid = (2 * nid + torch.where(goleft, 0, 1)).to(torch.int32)
    nleaf = 2 ** depth
    st_t = segment_sum(nid, torch.stack([wt, wt * y], dim=1), n_nodes=nleaf,
                       mesh=mesh)
    st_c = segment_sum(nid, torch.stack([wc, wc * y], dim=1), n_nodes=nleaf,
                       mesh=mesh)
    p_t = _smooth_p(st_t[:, 1], st_t[:, 0])
    p_c = _smooth_p(st_c[:, 1], st_c[:, 0])
    tree = Tree(feats, threshs, na_lefts, is_splits, p_t - p_c,
                st_t[:, 0] + st_c[:, 0], *zero_catsplit(depth, Lmax, dev))
    return tree, p_t, p_c


def auuc(uplift_pred: np.ndarray, y: np.ndarray, treat: np.ndarray,
         nbins: int = 1000, auuc_type: str = "qini") -> Dict[str, float]:
    """AUUC / Qini from the cumulative uplift curve
    (hex/AUUC.java semantics: rows sorted by predicted uplift desc;
    curve types qini / lift / gain per hex/AUUC.AUUCType)."""
    order = np.argsort(-uplift_pred, kind="stable")
    y, tr = y[order], treat[order]
    n = len(y)
    idx = np.linspace(0, n, min(nbins, n) + 1).astype(int)[1:]
    cy_t = np.cumsum(y * tr)
    cn_t = np.cumsum(tr)
    cy_c = np.cumsum(y * (1 - tr))
    cn_c = np.cumsum(1 - tr)

    def curve_at(k: int, kind: str) -> float:
        nt, nc = cn_t[k], cn_c[k]
        rt = cy_t[k] / nt if nt > 0 else 0.0
        rc = cy_c[k] / nc if nc > 0 else 0.0
        if kind == "qini":
            return cy_t[k] - (cy_c[k] * nt / nc if nc > 0 else 0.0)
        if kind == "lift":
            return rt - rc
        return (rt - rc) * (nt + nc)   # gain

    kind = auuc_type if auuc_type in ("qini", "lift", "gain") else "qini"
    vals = np.asarray([curve_at(k, kind) for k in idx - 1])
    qini = np.asarray([curve_at(k, "qini") for k in idx - 1])
    auuc_v = float(vals.mean())
    # random-targeting baseline endpoint (on the qini curve)
    q_final = curve_at(n - 1, "qini")
    qini_coef = float(qini.mean() - q_final / 2.0)
    return {"auuc": auuc_v, "qini": qini_coef, "auuc_type": kind,
            "uplift_top_decile": float(vals[max(len(vals) // 10 - 1, 0)])}


class UpliftDRFModel(Model):
    algo = "upliftdrf"

    def __init__(self, params, output, forest: Tree, leaf_pt, leaf_pc,
                 bm: BinnedMatrix):
        super().__init__(params, output)
        self.forest = forest
        self.leaf_pt = leaf_pt      # [T, 2^D]
        self.leaf_pc = leaf_pc
        self.bm = bm

    def _rates(self, frame: Frame, get) -> Dict[str, np.ndarray]:
        """The prediction columns from ``get``, the host copy of the
        frame's rows of a device tensor."""
        bm = rebin_for_scoring(self.bm, frame)
        B = self.bm.nbins_total
        T = self.forest.feat.shape[0]
        # tree leaves are p_t - p_c by construction, so uplift falls out
        # of the two class-rate scans without a third forest walk
        pt = get(predict_forest(
            self.forest._replace(leaf=self.leaf_pt), bm.bins, B)) / T
        pc = get(predict_forest(
            self.forest._replace(leaf=self.leaf_pc), bm.bins, B)) / T
        return {"uplift_predict": pt - pc, "p_y1_ct1": pt, "p_y1_ct0": pc}

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._rates(frame, lambda t: fetch_replicated(
            t, frame.mesh)[:frame.nrows])

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._rates(frame, lambda t: fetch(t)[:frame.local_nrows])

    def model_performance(self, frame: Frame):
        raw = self._score_raw(frame)
        y = adapt_domain(frame.col(self.output["response"]),
                         self.output["domain"])[: frame.nrows]
        tr = adapt_domain(frame.col(self.params["treatment_column"]),
                          self.output["treatment_domain"])[: frame.nrows]
        ok = (y >= 0) & (tr >= 0)
        nbins = int(self.params.get("auuc_nbins") or -1)
        atype = str(self.params.get("auuc_type") or "auto").lower()
        a = auuc(raw["uplift_predict"][ok], y[ok].astype(float),
                 tr[ok].astype(float),
                 nbins=nbins if nbins > 0 else 1000,
                 auuc_type="qini" if atype == "auto" else atype)
        return mm.ModelMetrics("BinomialUplift", int(ok.sum()),
                               float(np.mean(raw["uplift_predict"] ** 2)),
                               **a)


class UpliftDRFEstimator(ModelBuilder):
    """h2o-py H2OUpliftRandomForestEstimator surface
    (h2o-py/h2o/estimators/uplift_random_forest.py). Cross-validation is
    not ported: ``nfolds``, ``fold_assignment`` or ``fold_column`` off
    their defaults raise ``NotImplementedError``."""

    algo = "upliftdrf"
    SHARDED = True

    DEFAULTS = dict(
        ntrees=50, max_depth=10, min_rows=10.0, nbins=64, nbins_cats=64,
        mtries=-2, sample_rate=0.632, seed=-1,
        treatment_column=None, uplift_metric="auto",
        auuc_type="auto", auuc_nbins=-1,
        ignored_columns=None, nfolds=0, fold_assignment="auto",
        weights_column=None, fold_column=None,
    )
    # cross-validation stays unported: the reference's CV reads a "p1"
    # column that uplift scoring does not make (it scores uplift_predict)
    PORTED = frozenset(DEFAULTS) - {"nfolds", "fold_assignment",
                                    "fold_column"}
    label = "UpliftDRF"

    def __init__(self, **params):
        super().__init__(**params)
        if not self.params.get("treatment_column"):
            raise ValueError("UpliftDRF requires treatment_column")

    def resolve_x(self, frame, x, y):
        x = super().resolve_x(frame, x, y)
        return [n for n in x if n != self.params["treatment_column"]]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        rc = frame.col(y)
        tc = frame.col(p["treatment_column"])
        if not (rc.is_categorical and rc.cardinality == 2):
            raise ValueError("UpliftDRF needs a 2-level categorical response")
        if not (tc.is_categorical and tc.cardinality == 2):
            raise ValueError("UpliftDRF needs a 2-level treatment column")
        metric = str(p["uplift_metric"]).lower().replace("chisquared",
                                                         "chi_squared")
        if metric == "auto":
            metric = "kl"
        if metric not in ("kl", "euclidean", "chi_squared"):
            raise ValueError(f"unknown uplift_metric '{p['uplift_metric']}'; "
                             "use KL, Euclidean or ChiSquared")
        w = frame.valid_weights()
        if p.get("weights_column") and p["weights_column"] in frame:
            wc_ = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc_), 0.0, wc_)
        # host mirror of w for the weighted bin sketch — no device fetch
        bm = bin_frame(frame, x, nbins=p["nbins"], nbins_cats=p["nbins_cats"],
                       weights=self._host_weights(frame, None))
        yv = adapt_domain(rc, rc.domain)
        trv = adapt_domain(tc, tc.domain)
        ok = (yv >= 0) & (trv >= 0)

        def dev_f32(a):
            return torch.from_numpy(frame.local_rows(
                a.astype(np.float32))).to(dev)

        w = w * dev_f32(ok)
        y_dev = dev_f32(np.maximum(yv, 0))
        t_dev = dev_f32(np.maximum(trv, 0))

        F = len(x)
        mtries = int(p["mtries"])
        if mtries == -1:
            mtries = max(int(np.sqrt(F)), 1)
        elif mtries == -2:
            mtries = F   # all columns (reference UpliftDRF default -2)
        depth = int(p["max_depth"])
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xD00D
        sample_rate = float(p["sample_rate"])
        trees, pts, pcs = [], [], []
        for t in range(int(p["ntrees"])):
            gen = tree_generator(seed, t, dev)
            keep = frame.uniform_rows(gen) < sample_rate
            tr_, pt_, pc_ = _grow_uplift_tree(
                bm.bins, bm.nbins, w * keep.to(torch.float32), y_dev, t_dev,
                gen, depth=depth, B=bm.nbins_total, mtries=mtries,
                metric=metric, min_rows=float(p["min_rows"]),
                mesh=frame.mesh)
            trees.append(tr_)
            pts.append(pt_)
            pcs.append(pc_)
        forest = stack_trees(trees)
        output = {"category": "BinomialUplift", "response": y,
                  "names": list(x), "domain": rc.domain,
                  "treatment_domain": tc.domain, "nclasses": 2}
        model = UpliftDRFModel(p, output, forest, torch.stack(pts),
                               torch.stack(pcs), bm)
        model.training_metrics = model.model_performance(frame)
        return model
