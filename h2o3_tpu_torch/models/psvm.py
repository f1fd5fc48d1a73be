"""PSVM — a Gaussian-kernel SVM on an incomplete Cholesky factorization.

Reference: h2o3_tpu/models/psvm.py (hex/psvm/PSVM.java, Chang et al.,
"PSVM: Parallelizing Support Vector Machines on Distributed Computers",
NIPS 2007). The RBF Gram matrix is approximated as K ≈ V·Vᵀ with a
rank-r incomplete Cholesky factorization (``icf``: r pivot steps, each
the argmax of the residual diagonal, one kernel column and a GEMV
against the columns so far, written in place into a preallocated
[N, r] V on the device), and the smooth L2-SVM primal is solved in the
r-dimensional feature space by Newton steps: the Gauss-Newton Hessian
I′ + 2·V1ᵀ(act·V1) from ``ops/gram.gram`` (TF32 held off) and a Cholesky
solve. Scoring maps a row x to k(x, pivots)·L⁻ᵀ.

``torch.argmax`` takes the first maximum, as the reference's does; a
pivot whose residual is within rounding of another's can differ from
the reference's, since the GEMV adds in another order.

Not ported: ``nfolds`` and ``fold_column`` (raise), a partitioned frame
(ROADMAP A #12′). It has no MOJO and no serving schema, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.datainfo import build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain, masked_weights,
                                         require_local)
from h2o3_tpu_torch.ops.gram import exact_f32, gram


def _rbf_rows(X, rows, gamma: float, x2=None):
    """K(X, rows) of the Gaussian kernel, [N, m] (``x2``: the row norms
    of X, if known)."""
    if x2 is None:
        x2 = (X * X).sum(1)
    with exact_f32():
        xr = X @ rows.T
    d2 = x2[:, None] + (rows * rows).sum(1)[None, :] - 2.0 * xr
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def icf(X, w_valid, gamma: float, rank: int):
    """Incomplete Cholesky of the RBF Gram matrix of the rows of X
    (``w_valid`` > 0): (V [N, rank'] with K ≈ V·Vᵀ, the pivot rows,
    rank' <= rank where the residual diagonal runs out)."""
    N = X.shape[0]
    valid = w_valid > 0
    diag = valid.to(torch.float32)            # K(x, x) = 1
    x2 = (X * X).sum(1)
    V = torch.zeros((N, rank), dtype=torch.float32, device=X.device)
    pivots = []
    for j in range(rank):
        piv_t = torch.argmax(diag)
        piv, dmax = torch.stack([piv_t.to(torch.float64),
                                 diag[piv_t].to(torch.float64)]).tolist()
        piv = int(piv)
        if dmax <= 1e-8:
            rank = j
            break
        pivots.append(piv)
        kcol = _rbf_rows(X, X[piv:piv + 1], gamma, x2)[:, 0]
        with exact_f32():
            vj = (kcol - V[:, :j] @ V[piv, :j]) / float(np.sqrt(
                np.float32(dmax)))
        V[:, j] = torch.where(valid, vj, 0.0)
        diag = torch.clamp_min(diag - V[:, j] * V[:, j], 0.0)
    return V[:, :rank], np.asarray(pivots, np.int64), rank


def _newton_step(w_b, V1, y, cw):
    """One Newton step on min 0.5·wᵀw + Σ cw·max(0, 1 − y·f)², f = V1 @
    [w; b]: (the new [w; b], the objective at the old one)."""
    with exact_f32():
        f = V1 @ w_b
    xi = 1.0 - y * f
    act = (xi > 0).to(torch.float32) * cw
    r = w_b.clone()
    r[-1] = 0.0                                 # the bias is free
    xtx, xtz, _ = gram(V1, act, y * xi)
    k = w_b.shape[0]
    H = torch.eye(k, dtype=torch.float32, device=w_b.device)
    H[-1, -1] = 1e-6
    H = H + 2.0 * xtx
    g = r - 2.0 * xtz
    delta = torch.cholesky_solve(g[:, None], torch.linalg.cholesky(H))[:, 0]
    return w_b - delta, (act * xi * xi).sum() + 0.5 * (r * r).sum()


class PSVMModel(Model):
    algo = "psvm"

    def __init__(self, params, output, w_b: np.ndarray, pivot_rows: np.ndarray,
                 Linv_t: np.ndarray, gamma: float, di_stats: dict,
                 features: List[str]):
        super().__init__(params, output)
        self.w_b = w_b                 # [r+1] weights and bias
        self.pivot_rows = pivot_rows   # [r, P] standardized pivot rows
        self.Linv_t = Linv_t           # [r, r] L^-T
        self.gamma = gamma
        self.di_stats = di_stats
        self.features = features

    def _decision(self, frame: Frame) -> torch.Tensor:
        """Decision values of the frame's padded rows, on its device."""
        require_local(frame, self.algo)
        di = build_datainfo(frame, self.features, standardize=True,
                            use_all_factor_levels=True,
                            stats_override=self.di_stats)
        dev = frame.device
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.array(a, np.float32)).to(dev)
        k = _rbf_rows(di.X, t(self.pivot_rows), self.gamma)
        with exact_f32():
            phi = k @ t(self.Linv_t)
            return phi @ t(self.w_b[:-1]) + float(self.w_b[-1])

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        f = self._decision(frame).cpu().numpy()[:frame.nrows]
        p1 = 1.0 / (1.0 + np.exp(-np.clip(f, -30, 30)))
        return {"predict": (f >= 0).astype(np.int32),
                "decision_function": f, "p0": 1.0 - p1, "p1": p1}

    def model_performance(self, frame: Frame, mask_weights=None):
        f = self._decision(frame)
        y = adapt_domain(frame.col(self.output["response"]),
                         self.output["domain"])
        y = torch.from_numpy(np.pad(y, (0, f.shape[0] - frame.nrows),
                                    constant_values=-1)).to(f.device)
        w = masked_weights(frame.valid_weights() * (y >= 0), mask_weights)
        p = 1.0 / (1.0 + torch.exp(-torch.clamp(f, -30, 30)))
        return mm.binomial_metrics(p, torch.clamp_min(y, 0).float(), w)


class PSVMEstimator(ModelBuilder):
    """h2o-py H2OSupportVectorMachineEstimator surface."""

    algo = "psvm"
    label = "PSVM"

    DEFAULTS = dict(
        hyper_param=1.0, kernel_type="gaussian", gamma=-1.0,
        rank_ratio=-1.0, positive_weight=1.0, negative_weight=1.0,
        sv_threshold=1e-4, max_iterations=200, ignored_columns=None,
        seed=-1, nfolds=0, fold_assignment="auto", weights_column=None,
        fold_column=None,
    )
    PORTED = frozenset(DEFAULTS) - {"nfolds", "fold_column"}

    def __init__(self, **params):
        super().__init__(**params)
        if str(self.params["kernel_type"]).lower() != "gaussian":
            raise ValueError("only kernel_type='gaussian' is supported "
                             "(reference PSVM.java supports gaussian only)")

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        rc = frame.col(y)
        if not (rc.is_categorical and rc.cardinality == 2):
            raise ValueError("PSVM needs a binary categorical response")
        di = build_datainfo(frame, x, standardize=True,
                            use_all_factor_levels=True)
        n = frame.nrows
        npad = di.X.shape[0]
        dev = frame.device
        yv = np.pad(adapt_domain(rc, rc.domain), (0, npad - n),
                    constant_values=-1)
        w_valid = np.pad(np.ones(n, np.float32), (0, npad - n)) * (yv >= 0)
        if p.get("weights_column") and p["weights_column"] in frame:
            wc = frame.col(p["weights_column"]).to_numpy()
            wc = np.pad(np.where(np.isnan(wc), 0.0, wc), (0, npad - n))
            w_valid = w_valid * wc
        w_valid = w_valid.astype(np.float32)
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.array(a, np.float32)).to(dev)
        ypm = t(np.where(yv == 1, 1.0, -1.0))

        gamma = float(p["gamma"])
        if gamma <= 0:
            gamma = 1.0 / max(di.P, 1)
        rr = float(p["rank_ratio"])
        rank = int(np.sqrt(n)) if rr <= 0 else max(int(n * rr), 1)
        rank = min(rank, 256, n)

        X = di.X
        V, pivots, rank = icf(X, t(w_valid), gamma, rank)
        V1 = torch.empty((npad, rank + 1), dtype=torch.float32, device=dev)
        V1[:, :rank] = V
        V1[:, rank] = 1.0
        V1 *= t(w_valid > 0)[:, None]

        C = float(p["hyper_param"])
        cw_h = np.where(yv == 1, C * float(p["positive_weight"]),
                        C * float(p["negative_weight"])).astype(np.float32) \
            * w_valid
        cw = t(cw_h)
        w_b = torch.zeros(rank + 1, dtype=torch.float32, device=dev)
        last = np.inf
        steps = 0
        for _ in range(int(p["max_iterations"])):
            w_b, obj = _newton_step(w_b, V1, ypm, cw)
            obj = float(obj)
            steps += 1
            if abs(last - obj) < 1e-7 * max(abs(obj), 1.0):
                break
            last = obj

        # support vectors from the L2-SVM KKT: alpha_i = 2 cw_i ξ_i
        with exact_f32():
            f = (V1 @ w_b).cpu().numpy()
        xi = np.maximum(1.0 - np.where(yv == 1, 1.0, -1.0) * f, 0.0)
        alpha = 2.0 * cw_h * xi
        sv = (alpha > float(p["sv_threshold"])) & (w_valid > 0)
        L = V[torch.from_numpy(pivots).to(dev)].cpu().numpy()
        Linv_t = np.linalg.solve(L.astype(np.float64),
                                 np.eye(rank)).T.astype(np.float32)
        pivot_rows = X[torch.from_numpy(pivots).to(dev)].cpu().numpy()
        output = {"category": ModelCategory.BINOMIAL, "response": y,
                  "names": list(x), "domain": rc.domain, "nclasses": 2,
                  "svs_count": int(sv.sum()),
                  "bsv_count": int(((alpha > 0) & (xi >= 1.0)).sum()),
                  "rank": rank, "gamma": gamma,
                  "default_threshold": 0.5, "iterations": steps}
        model = PSVMModel(p, output, w_b.cpu().numpy(), pivot_rows, Linv_t,
                          gamma, stats_of(di), list(x))
        model.training_metrics = model.model_performance(frame)
        return model
