"""Model metrics — binomial, multinomial and regression.

Reference: h2o3_tpu/models/metrics.py (hex/ModelMetrics*.java, exact AUC
from a 400-bin score histogram, hex/AUC2.java:24). One device pass builds
the weighted sums and the score histogram (per-row terms in float32 as
the reference forms them, sums in float64); the host finishes the
scalars. On a sharded mesh each rank passes its own rows and the sums
and the histogram are all-reduced before the host finishes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.ops.fixed_point import index_sum
from h2o3_tpu_torch.parallel.map_reduce import all_reduce

AUC_NBINS = 400  # hex/AUC2.java:24

# numpy >= 2 renamed trapz; accept either
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _scatter_sum(n: int, idx, vals):
    """float64 sums of the rows of ``vals`` by ``idx`` in [0, n): one
    ``index_add_`` on the CPU; fixed point on the card, where a float
    ``index_add_`` adds in an order that changes from run to run."""
    if vals.device.type == "cuda":
        return index_sum(idx, vals, n)
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _binomial_pass(p, y, w):
    pc = torch.clamp(p, 1e-7, 1 - 1e-7)
    terms = torch.stack([w,
                         w * (p - y) ** 2,
                         -w * (y * torch.log(pc) + (1 - y) * torch.log(1 - pc)),
                         w * y], dim=1)
    sums = terms.to(torch.float64).sum(dim=0)
    bins = torch.clamp((pc * AUC_NBINS).to(torch.int32), 0, AUC_NBINS - 1)
    hist = _scatter_sum(AUC_NBINS, bins.long(),
                        torch.stack([w * y, w * (1.0 - y)], dim=1).double())
    return sums, hist


def _auc_from_hist(pos: np.ndarray, neg: np.ndarray) -> Dict[str, float]:
    """AUC + AUCPR + max-F1 threshold from the bin histograms
    (hex/AUC2.java compute path)."""
    # sweep thresholds from high to low: cumulative TP/FP
    tp = np.cumsum(pos[::-1])[::-1]
    fp = np.cumsum(neg[::-1])[::-1]
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        return {"auc": 0.5, "pr_auc": 0.0, "max_f1": 0.0,
                "max_f1_threshold": 0.5, "gini": 0.0}
    tpr = np.concatenate([tp / P, [0.0]])
    fpr = np.concatenate([fp / N, [0.0]])
    auc = float(_trapezoid(tpr[::-1], fpr[::-1]))
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / P
    order = np.argsort(rec)
    pr_auc = float(_trapezoid(np.concatenate([[prec[order][0]], prec[order]]),
                              np.concatenate([[0.0], rec[order]])))
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
    k = int(np.argmax(f1))
    return {"auc": auc, "pr_auc": pr_auc, "max_f1": float(f1[k]),
            "max_f1_threshold": float(k / AUC_NBINS), "gini": 2 * auc - 1}


class ModelMetrics:
    """Base: shared scalar fields (hex/ModelMetrics.java)."""

    def __init__(self, kind: str, nobs: int, mse: float, **extra):
        self.kind = kind
        self.nobs = nobs
        self.mse = mse
        self.rmse = float(np.sqrt(mse))
        self.extra = extra

    def to_dict(self) -> dict:
        d = {"model_category": self.kind, "nobs": self.nobs,
             "MSE": self.mse, "RMSE": self.rmse}
        d.update(self.extra)
        return d

    def __getitem__(self, k):
        return self.to_dict()[k]

    def __repr__(self):
        items = ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in self.to_dict().items() if not isinstance(v, (list, dict)))
        return f"<ModelMetrics {items}>"


def _as_f32(x, like: torch.Tensor = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = like.device if like is not None else None
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def binomial_metrics(p, y, w=None, mesh=None) -> ModelMetrics:
    """hex/ModelMetricsBinomial.java: AUC/logloss/Brier from one pass.

    p: P(class 1) [N]; y: 0/1 labels; w: weights (0 on padding rows).
    On a sharded ``mesh`` the metrics cover every rank's rows.
    """
    p = _as_f32(p)
    y = _as_f32(y, p)
    w = torch.ones_like(p) if w is None else _as_f32(w, p)
    sums, hist = (all_reduce(t, mesh) for t in _binomial_pass(p, y, w))
    tot, sse, ll, pos = (float(x) for x in sums.cpu().numpy())
    hist = hist.cpu().numpy()
    pos_h, neg_h = hist[:, 0], hist[:, 1]
    roc = _auc_from_hist(pos_h, neg_h)
    t = roc["max_f1_threshold"]
    # confusion at max-F1 threshold (reference default criterion)
    idx = int(t * AUC_NBINS)
    tp = pos_h[idx:].sum(); fp = neg_h[idx:].sum()
    fn = pos_h[:idx].sum(); tn = neg_h[:idx].sum()
    err0 = fp / max(fp + tn, 1e-12)
    err1 = fn / max(fn + tp, 1e-12)
    mm = ModelMetrics(
        "Binomial", int(tot), sse / max(tot, 1e-12),
        logloss=ll / max(tot, 1e-12),
        AUC=roc["auc"], pr_auc=roc["pr_auc"], Gini=roc["gini"],
        max_f1=roc["max_f1"], max_f1_threshold=t,
        mean_per_class_error=float((err0 + err1) / 2),
        confusion_matrix=[[float(tn), float(fp)], [float(fn), float(tp)]],
        positive_fraction=pos / max(tot, 1e-12))
    mm.hist = (pos_h, neg_h)
    return mm


def _multinomial_pass(probs, y, w, hists: bool):
    """The multinomial sums [w, -w·log p_y, w·error, w·Σ(p - onehot)²],
    the K×K confusion matrix (true × predicted) and, with ``hists``, the
    [K(prob), K(true), AUC_NBINS] score histograms — weight of rows of
    true class j whose class-k probability lands in each bin
    (hex/MultinomialAUC.java; one structure serves one-vs-rest and
    one-vs-one)."""
    N, K = probs.shape
    yl = y.long()
    py = torch.clamp(probs.gather(1, yl[:, None])[:, 0], 1e-7, 1.0)
    pred = torch.argmax(probs, dim=1)
    err = (pred != yl).to(torch.float32)
    onehot = (torch.arange(K, device=probs.device)[None, :]
              == yl[:, None]).to(torch.float32)
    sse = torch.sum((probs - onehot) ** 2, dim=1)
    sums = torch.stack([w, -w * torch.log(py), w * err, w * sse],
                       dim=1).to(torch.float64).sum(dim=0)
    wd = w.to(torch.float64)
    cm = _scatter_sum(K * K, yl * K + pred, wd)
    if not hists:
        return sums, cm, None
    b = torch.clamp((probs * AUC_NBINS).to(torch.int32), 0, AUC_NBINS - 1)
    cell = ((torch.arange(K, device=probs.device)[None, :] * K
             + yl[:, None]) * AUC_NBINS + b.long()).reshape(-1)
    hist = _scatter_sum(K * K * AUC_NBINS, cell,
                        wd[:, None].expand(N, K).reshape(-1))
    return sums, cm, hist


def _multinomial_auc_tables(H: np.ndarray, row: np.ndarray,
                            domain: List[str]) -> dict:
    """One-vs-rest and one-vs-one AUC / PR-AUC tables from the score
    histograms; the scalar AUC and PR-AUC are the weighted OVR."""
    K = H.shape[0]
    frac = row / max(row.sum(), 1e-12)
    auc_rows, pr_rows = [], []
    ovr_auc, ovr_pr = np.zeros(K), np.zeros(K)
    for k in range(K):
        pos = H[k, k]
        r = _auc_from_hist(pos, H[k].sum(axis=0) - pos)
        ovr_auc[k], ovr_pr[k] = r["auc"], r["pr_auc"]
        auc_rows.append([f"{domain[k]} vs Rest", domain[k], "",
                         float(r["auc"])])
        pr_rows.append([f"{domain[k]} vs Rest", domain[k], "",
                        float(r["pr_auc"])])
    for rows, v in ((auc_rows, ovr_auc), (pr_rows, ovr_pr)):
        rows.append(["Macro OVR", "", "", float(v.mean())])
        rows.append(["Weighted OVR", "", "", float((v * frac).sum())])
    ovo_auc, ovo_pr, ovo_w = [], [], []
    for i in range(K):
        for j in range(i + 1, K):
            # symmetric pairwise AUC: the mean of the i-scored and the
            # j-scored directions
            ri = _auc_from_hist(H[i, i], H[i, j])
            rj = _auc_from_hist(H[j, j], H[j, i])
            a = 0.5 * (ri["auc"] + rj["auc"])
            pr = 0.5 * (ri["pr_auc"] + rj["pr_auc"])
            ovo_auc.append(a)
            ovo_pr.append(pr)
            ovo_w.append(frac[i] + frac[j])
            auc_rows.append([f"{domain[i]} vs {domain[j]}", domain[i],
                             domain[j], float(a)])
            pr_rows.append([f"{domain[i]} vs {domain[j]}", domain[i],
                            domain[j], float(pr)])
    ow = np.asarray(ovo_w) / max(sum(ovo_w), 1e-12)
    for rows, v in ((auc_rows, ovo_auc), (pr_rows, ovo_pr)):
        rows.append(["Macro OVO", "", "", float(np.mean(v))])
        rows.append(["Weighted OVO", "", "",
                     float((np.asarray(v) * ow).sum())])
    return {"multinomial_auc_rows": auc_rows,
            "multinomial_aucpr_rows": pr_rows,
            "AUC": float((ovr_auc * frac).sum()),
            "pr_auc": float((ovr_pr * frac).sum())}


def multinomial_metrics(probs, y, w=None, mesh=None,
                        domain: Optional[List[str]] = None) -> ModelMetrics:
    """hex/ModelMetricsMultinomial.java: logloss, MSE, error rate, the
    confusion matrix and mean per-class error from one pass; for
    2 <= K <= 30 also the one-vs-rest and one-vs-one AUC / PR-AUC tables
    (hex/MultinomialAUC.java), the scalar ``AUC`` and ``pr_auc`` being
    the weighted one-vs-rest.

    probs: [N, K] class probabilities; y: class codes [N]; w: weights (0
    on padding rows). On a sharded ``mesh`` the metrics cover every
    rank's rows.
    """
    probs = _as_f32(probs)
    K = probs.shape[1]
    y = torch.as_tensor(y).to(probs.device)
    w = (torch.ones(probs.shape[0], dtype=torch.float32,
                    device=probs.device) if w is None else _as_f32(w, probs))
    sums, cm, hist = _multinomial_pass(probs, y, w, hists=2 <= K <= 30)
    tot, ll, err, sse = (float(v) for v in all_reduce(sums, mesh).cpu())
    cm = all_reduce(cm, mesh).cpu().numpy().reshape(K, K)
    row = cm.sum(axis=1)
    per_class_err = np.where(row > 0, 1.0 - np.diag(cm)
                             / np.maximum(row, 1e-12), 0.0)
    extra = {}
    if hist is not None:
        H = all_reduce(hist, mesh).cpu().numpy().reshape(K, K, AUC_NBINS)
        extra = _multinomial_auc_tables(
            H, row, domain or [f"class_{i}" for i in range(K)])
    return ModelMetrics(
        "Multinomial", int(tot), sse / max(tot, 1e-12),
        logloss=ll / max(tot, 1e-12),
        mean_per_class_error=float(per_class_err[row > 0].mean())
        if (row > 0).any() else 0.0,
        error_rate=err / max(tot, 1e-12),
        confusion_matrix=cm.tolist(), domain=domain, **extra)


def regression_metrics(pred, y, w=None, deviance_fn=None,
                       mesh=None) -> ModelMetrics:
    """hex/ModelMetricsRegression.java: MSE/MAE/RMSLE/deviance/R2; on a
    sharded ``mesh`` over every rank's rows."""
    pred = _as_f32(pred)
    y = _as_f32(y, pred)
    w = torch.ones_like(y) if w is None else _as_f32(w, pred)
    dev = deviance_fn(y, pred) if deviance_fn is not None else (y - pred) ** 2
    ok_log = (y > -1) & (pred > -1)
    rmsle_term = torch.where(
        ok_log, (torch.log1p(torch.clamp_min(pred, -1 + 1e-12))
                 - torch.log1p(torch.clamp_min(y, -1 + 1e-12))) ** 2, 0.0)
    terms = torch.stack([w, w * (y - pred) ** 2, w * torch.abs(y - pred),
                         w * rmsle_term, w * y, w * y * y,
                         w * dev.to(torch.float32)], dim=1)
    sums = all_reduce(terms.to(torch.float64).sum(dim=0), mesh)
    tot, sse, sae, sle, sy, syy, sdev = (float(x) for x in sums.cpu().numpy())
    mse = sse / max(tot, 1e-12)
    var_y = syy / max(tot, 1e-12) - (sy / max(tot, 1e-12)) ** 2
    return ModelMetrics(
        "Regression", int(tot), mse,
        mae=sae / max(tot, 1e-12),
        rmsle=float(np.sqrt(sle / max(tot, 1e-12))),
        mean_residual_deviance=sdev / max(tot, 1e-12),
        r2=1.0 - mse / max(var_y, 1e-12))
