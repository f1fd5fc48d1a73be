"""GAM — generalized additive models: a spline basis and a penalized IRLS.

Reference: h2o3_tpu/models/gam.py (hex/gam/GAM.java). Each gam column
gets cubic B-splines on quantile knots (the knots from the column's
float64 host view, as the reference takes them), its first basis column
dropped and the rest centered on the training rows, and a
second-difference curvature penalty scaled by ``scale``; the linear
predictors enter through ``frame/datainfo.py``'s design with a ridge
``lambda·(1 − alpha)``. The fit is the reference's penalized IRLS: a
Gram pass (``ops/gram.gram``, TF32 off) and a Cholesky solve of
``X'WX/nobs + P + 1e-7·I`` a step, one host sync for the stopping test.

The basis is built on the frame's device in float64, with the
reference's Cox–de Boor recursion in the reference's order (each
element takes the same IEEE operations), then centered and cast to
float32: the reference runs those column passes in host numpy.
``residual_deviance`` is the deviance at the coefficients before the
last update, as the reference reports it.

Not ported: GAM on a frame partitioned over a sharded mesh (ROADMAP
A #12′). It has no MOJO and no serving schema, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.datainfo import build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.glm import Family
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain, infer_category,
                                         masked_weights, require_local)
from h2o3_tpu_torch.ops.gram import exact_f32, gram
from h2o3_tpu_torch.ops.optimize import cho_factor, cho_solve
from h2o3_tpu_torch.parallel.device import fetch


def bspline_basis(x: torch.Tensor, knots: np.ndarray,
                  degree: int = 3) -> torch.Tensor:
    """Cox–de Boor B-spline basis [n, nb] in float64 over the knots
    extended by ``degree`` equal steps on each side, on ``x``'s device;
    NaN rows get a zero basis (the reference's ``bspline_basis``)."""
    knots = np.asarray(knots, np.float64)
    h = knots[1] - knots[0] if len(knots) > 1 else 1.0
    ext = np.concatenate([knots[0] - h * np.arange(degree, 0, -1), knots,
                          knots[-1] + h * np.arange(1, degree + 1)])
    x = x.to(torch.float64)
    dev = x.device
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=dev)
    ok = torch.isfinite(x)
    xc = torch.where(ok, torch.clamp(x, float(knots[0]), float(knots[-1])),
                     float(knots[0]))[:, None]
    # degree 0: the indicator of each knot span; the last point belongs
    # to the final non-empty span
    B = ((xc >= t(ext[:-1])) & (xc < t(ext[1:]))).to(torch.float64)
    last = np.searchsorted(ext, knots[-1], side="right") - 1
    onehot = torch.zeros(B.shape[1], dtype=torch.float64, device=dev)
    onehot[last] = 1.0
    B = torch.where(xc >= float(knots[-1]), onehot, B)
    for d in range(1, degree + 1):
        m = B.shape[1] - 1
        den1 = ext[d:d + m] - ext[:m]
        den2 = ext[d + 1:d + 1 + m] - ext[1:1 + m]
        t1 = ((xc - t(ext[:m])) / t(np.where(den1 > 0, den1, 1.0))) \
            * B[:, :m]
        t2 = ((t(ext[d + 1:d + 1 + m]) - xc)
              / t(np.where(den2 > 0, den2, 1.0))) * B[:, 1:]
        B = (torch.where(torch.as_tensor(den1 > 0, device=dev), t1, 0.0)
             + torch.where(torch.as_tensor(den2 > 0, device=dev), t2, 0.0))
    return torch.where(ok[:, None], B, 0.0)


def curvature_penalty(nb: int) -> np.ndarray:
    """S = D2'D2, the P-spline second-difference curvature penalty."""
    D = np.zeros((nb - 2, nb))
    for i in range(nb - 2):
        D[i, i], D[i, i + 1], D[i, i + 2] = 1.0, -2.0, 1.0
    return D.T @ D


def gam_knots(xnp: np.ndarray, k: int) -> np.ndarray:
    """Quantile knots of a column's host view (unique; four equal steps
    over its range when fewer than four are distinct)."""
    knots = np.unique(np.nanquantile(xnp, np.linspace(0, 1, int(k))))
    if len(knots) < 4:
        knots = np.linspace(np.nanmin(xnp), np.nanmax(xnp) + 1e-6, 4)
    return knots


def penalty_matrix(n_lin: int, gam_spec: List[dict],
                   params: dict) -> np.ndarray:
    """The float32 penalty of the design [linear | splines | ones]: each
    spline block's curvature penalty times its scale, and the ridge
    lambda·(1 − alpha) of the GLM on the linear coefficients only."""
    widths = [len(s["means"]) for s in gam_spec]
    P = n_lin + sum(widths) + 1
    Pfull = np.zeros((P, P), np.float32)
    off = n_lin
    for s, nb in zip(gam_spec, widths):
        Pfull[off:off + nb, off:off + nb] = \
            s["scale"] * curvature_penalty(nb + 1)[1:, 1:]
        off += nb
    lam = params["lambda_"]
    lam = float(lam[0] if isinstance(lam, (list, tuple)) else lam)
    for i in range(n_lin):
        Pfull[i, i] += lam * (1.0 - float(params["alpha"] or 0.0))
    return Pfull


def _spline_block(frame: Frame, spec: dict, npad: int,
                  means: Optional[np.ndarray] = None):
    """(centered float32 basis [npad, nb - 1] without its first column,
    the float64 centering means) of a gam column; ``means`` None takes
    them over the frame's rows."""
    xnp = frame.col(spec["col"]).host_view()
    x = torch.from_numpy(np.pad(xnp, (0, npad - len(xnp)),
                                constant_values=np.nan)).to(frame.device)
    B = bspline_basis(x, spec["knots"])[:, 1:]
    mu = (B[:frame.nrows].mean(dim=0) if means is None
          else torch.from_numpy(np.asarray(means, np.float64)).to(B.device))
    return (B - mu).to(torch.float32), fetch(mu)


def _design(di, blocks: List[torch.Tensor]) -> torch.Tensor:
    """[linear design | spline blocks | ones] in one float32 allocation."""
    P = di.P
    widths = [b.shape[1] for b in blocks]
    X1 = torch.empty((di.X1.shape[0], P + sum(widths) + 1),
                     dtype=torch.float32, device=di.X1.device)
    X1[:, :P] = di.X
    off = P
    for b in blocks:
        X1[:, off:off + b.shape[1]] = b
        off += b.shape[1]
    X1[:, off] = 1.0
    return X1


def _pirls_iter(X1, coef, y, w, Pmat, fam: Family):
    """One penalized-IRLS step → (new coefficients, their largest change,
    the deviance at ``coef``)."""
    eta = X1 @ coef
    mu = fam.linkinv(eta)
    d = fam.dmu_deta(eta, mu)
    z = eta + (y - mu) / torch.where(torch.abs(d) < 1e-10, 1e-10, d)
    w_irls = w * d * d / torch.clamp_min(fam.variance(mu), 1e-10)
    dev = torch.sum(w * fam.deviance(y, mu))
    xtx, xtz, _ = gram(X1, w_irls, z)
    nobs = torch.clamp_min(w.sum(), 1.0)
    A = xtx / nobs + Pmat
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    new = cho_solve(cho_factor(A + 1e-7 * eye), xtz / nobs)
    return new, torch.max(torch.abs(new - coef)), dev


class GAMModel(Model):
    algo = "gam"

    def __init__(self, params, output, coef, family: Family, di_stats,
                 features, gam_spec: List[dict]):
        super().__init__(params, output)
        self.coef = coef
        self.family = family
        self.di_stats = di_stats
        self.features = features
        self.gam_spec = gam_spec   # per gam column: knots, basis means

    def _design(self, frame: Frame) -> torch.Tensor:
        require_local(frame, self.algo)
        di = build_datainfo(frame, self.features,
                            standardize=self.params.get("standardize", True),
                            use_all_factor_levels=False,
                            stats_override=self.di_stats)
        npad = di.X1.shape[0]
        return _design(di, [_spline_block(frame, s, npad, s["means"])[0]
                            for s in self.gam_spec])

    def _eta(self, frame: Frame) -> torch.Tensor:
        X1 = self._design(frame)
        with exact_f32():
            return X1 @ torch.from_numpy(np.array(
                self.coef, np.float32)).to(X1.device)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        mu = fetch(self.family.linkinv(self._eta(frame)))[:frame.nrows]
        if self.output["category"] == ModelCategory.BINOMIAL:
            t = self.output.get("default_threshold", 0.5)
            return {"predict": (mu >= t).astype(np.int32),
                    "p0": 1.0 - mu, "p1": mu}
        return {"predict": mu}

    def model_performance(self, frame: Frame, mask_weights=None):
        y = self.output["response"]
        eta = self._eta(frame)
        w = masked_weights(frame.valid_weights(), mask_weights)
        if self.output["category"] == ModelCategory.BINOMIAL:
            yv = frame.local_rows(adapt_domain(frame.col(y),
                                               self.output["domain"]), -1)
            w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(
                w.device)
            yt = torch.from_numpy(np.maximum(yv, 0).astype(np.float32))
            return mm.binomial_metrics(self.family.linkinv(eta),
                                       yt.to(w.device), w)
        yv = frame.col(y).numeric_view()
        w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
        yv = torch.where(torch.isnan(yv), 0.0, yv)
        return mm.regression_metrics(self.family.linkinv(eta), yv, w,
                                     deviance_fn=self.family.deviance)


class GAMEstimator(ModelBuilder):
    """h2o-py H2OGeneralizedAdditiveEstimator surface
    (h2o-py/h2o/estimators/gam.py). ``Lambda`` aliases ``lambda_``;
    ``bs`` and ``keep_gam_cols`` are accepted and inert, as in the
    reference (cubic B-splines only, no gam columns kept)."""

    algo = "gam"
    label = "GAM"

    DEFAULTS = dict(
        gam_columns=None, num_knots=None, scale=None, bs=None,
        family="auto", link=None, lambda_=0.0, alpha=0.0,
        standardize=True, max_iterations=50, beta_epsilon=1e-4,
        tweedie_power=1.5, seed=-1, nfolds=0, fold_assignment="auto",
        weights_column=None, fold_column=None, ignored_columns=None,
        keep_gam_cols=False,
    )
    PORTED = frozenset(DEFAULTS)

    def __init__(self, **params):
        if "Lambda" in params:
            params["lambda_"] = params.pop("Lambda")
        super().__init__(**params)
        if not self.params.get("gam_columns"):
            raise ValueError("GAM requires gam_columns")

    def resolve_x(self, frame, x, y):
        x = super().resolve_x(frame, x, y)
        gc = set(self.params["gam_columns"] or [])
        return [n for n in x if n not in gc]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        with exact_f32():
            return self._fit_gam(frame, list(x), y)

    def _fit_gam(self, frame: Frame, x: List[str], y: str) -> Model:
        p = self.params
        dev = frame.device
        category = infer_category(frame, y)
        fam_name = p["family"]
        if fam_name == "auto":
            fam_name = {"Binomial": "binomial",
                        "Regression": "gaussian"}.get(category)
            if fam_name is None:
                raise ValueError(f"GAM: unsupported category {category}")
        fam = Family(fam_name, float(p["tweedie_power"]), p["link"])
        gam_cols: List[str] = list(p["gam_columns"])
        nk = p["num_knots"] or [10] * len(gam_cols)
        scales = p["scale"] or [1.0] * len(gam_cols)

        di = build_datainfo(frame, x, standardize=bool(p["standardize"]),
                            use_all_factor_levels=False)
        npad = di.X1.shape[0]
        blocks, gam_spec = [], []
        coef_names = list(di.coef_names)
        for gc, k, sc in zip(gam_cols, nk, scales):
            spec = {"col": gc, "knots": gam_knots(frame.col(gc).host_view(),
                                                  k), "scale": float(sc)}
            B, spec["means"] = _spline_block(frame, spec, npad)
            gam_spec.append(spec)
            blocks.append(B)
            coef_names += [f"{gc}_spline_{i}" for i in range(B.shape[1])]
        X1 = _design(di, blocks)
        n_lin, stats = di.P, stats_of(di)
        del di, blocks                  # X1 holds the design now
        Pmat = torch.from_numpy(penalty_matrix(n_lin, gam_spec, p)).to(dev)

        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        rc = frame.col(y)
        if category == ModelCategory.BINOMIAL:
            yraw = frame.local_rows(adapt_domain(rc, rc.domain), -1)
            yv = np.maximum(yraw, 0).astype(np.float32)
            ok = (yraw >= 0).astype(np.float32)
        else:
            yn = frame.local_rows(rc.host_view(), np.nan)
            ok = (~np.isnan(yn)).astype(np.float32)
            yv = np.nan_to_num(yn).astype(np.float32)
        w = w * torch.from_numpy(ok).to(dev)
        y_dev = torch.from_numpy(yv).to(dev)

        coef = torch.zeros((X1.shape[1],), dtype=torch.float32, device=dev)
        devi = torch.tensor(np.inf)
        iters = 0
        for iters in range(1, int(p["max_iterations"]) + 1):
            coef, delta, devi = _pirls_iter(X1, coef, y_dev, w, Pmat, fam)
            if float(delta) < float(p["beta_epsilon"]):
                break

        output = {"category": category, "response": y, "names": list(x),
                  "gam_columns": gam_cols, "coef_names": coef_names,
                  "domain": rc.domain,
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "residual_deviance": float(devi),
                  "pirls_iterations": iters}
        model = GAMModel(p, output, fetch(coef), fam, stats, list(x),
                         gam_spec)
        mu = fam.linkinv(X1 @ coef)
        if category == ModelCategory.BINOMIAL:
            model.training_metrics = mm.binomial_metrics(mu, y_dev, w)
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        else:
            model.training_metrics = mm.regression_metrics(
                mu, y_dev, w, deviance_fn=fam.deviance)
        return model
