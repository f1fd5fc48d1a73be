"""ANOVA-GLM and ModelSelection — the GLM wrapper algorithms.

Reference: h2o3_tpu/models/model_selection.py (hex/anovaglm/ANOVAGLM.java,
hex/modelselection/). ANOVA-GLM fits the full GLM over every term (the
predictors and, with ``highest_interaction_term`` >= 2, the pairwise
products of the numeric ones) and one GLM without each term; a term's
likelihood-ratio statistic is the reduced deviance less the full one,
and its p-value the chi-square tail at the term's degrees of freedom.
ModelSelection keeps the best GLM per predictor count by ``r2`` (or
−logloss) under the modes ``allsubsets``, ``backward``, ``forward`` and
``maxr`` (forward with a replacement sweep).

Every candidate is one ``models/glm.GLMEstimator`` fit, which builds
its own design, as in the reference. ANOVA-GLM's product columns go
into a new frame over the caller's columns (shared, not copied), and
the model makes them again on each frame it scores: the reference adds
them to the caller's frame (ROADMAP C). Its
cross-validation is not ported: the reference's fails (ROADMAP C).
``p_values_threshold`` is accepted and inert, as in the reference; so
are ``link`` and ``tweedie_power``, which neither wrapper hands to its
GLMs.

Not ported: the wrappers on a partitioned frame (ROADMAP A #12′). They
have no MOJO and no serving schema, as in the reference.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.frame.column import column_from_numpy
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import GLMEstimator
from h2o3_tpu_torch.models.model import (Model, ModelBuilder,
                                         infer_category, require_local)


def _chi2_sf(x: float, df: int) -> float:
    """The chi-square survival function at ``x`` with ``df`` degrees of
    freedom."""
    from scipy.stats import chi2
    return float(chi2.sf(max(x, 0.0), max(df, 1)))


def _fit_glm(frame: Frame, x, y: str, family: str, **kw) -> Model:
    return GLMEstimator(family=family, **kw).train(frame, y=y, x=list(x))


def _resid_deviance(m: Model) -> float:
    d = m.training_metrics.to_dict()
    if "mean_residual_deviance" in d:
        return d["mean_residual_deviance"] * d["nobs"]
    return d["logloss"] * d["nobs"] * 2.0


def _family(p: dict, category: str, label: str,
            default: Optional[str] = None) -> str:
    family = p["family"]
    if family == "auto":
        family = {"Binomial": "binomial",
                  "Regression": "gaussian"}.get(category, default)
        if family is None:
            raise ValueError(f"{label}: unsupported category {category}")
    return family


def _glm_kw(p: dict) -> dict:
    return dict(lambda_=p["lambda_"], alpha=p["alpha"],
                standardize=p["standardize"],
                max_iterations=p["max_iterations"],
                weights_column=p.get("weights_column"))


class ANOVAGLMModel(Model):
    """Scores with the full model, on the frame it is given plus the
    product columns of the table's interaction terms (made for the
    scoring, as the fit made them)."""

    algo = "anovaglm"

    def __init__(self, params, output, full_model: Model):
        super().__init__(params, output)
        self.full_model = full_model

    def _with_products(self, frame):
        return with_products(frame, [tuple(r["term"].split(":"))
                                     for r in self.output["anova_table"]
                                     if ":" in r["term"]])

    def _score_raw(self, frame):
        return self.full_model._score_raw(self._with_products(frame))

    def model_performance(self, frame, mask_weights=None):
        return self.full_model.model_performance(
            self._with_products(frame), mask_weights)

    @property
    def anova_table(self) -> List[dict]:
        return self.output["anova_table"]


def with_products(frame: Frame, pairs: Sequence[tuple]) -> Frame:
    """A new frame over ``frame``'s columns (shared) and the product
    column ``a:b`` of each numeric pair not already in it: the float64
    host product, as the reference forms it."""
    cols = [frame.col(n) for n in frame.names]
    for a, b in pairs:
        nm = f"{a}:{b}"
        if nm not in frame:
            cols.append(column_from_numpy(
                nm, frame.col(a).host_view() * frame.col(b).host_view(),
                frame.nrows_padded, frame.device))
    return Frame(cols, frame.nrows, frame.device, npad=frame.nrows_padded,
                 block=frame.block)


class ANOVAGLMEstimator(ModelBuilder):
    """h2o-py H2OANOVAGLMEstimator surface
    (h2o-py/h2o/estimators/anovaglm.py): each term's significance from
    the deviance gain of adding it last."""

    algo = "anovaglm"
    label = "ANOVAGLM"

    DEFAULTS = dict(
        family="auto", link=None, lambda_=0.0, alpha=0.0,
        standardize=True, max_iterations=50, tweedie_power=1.5,
        highest_interaction_term=2, seed=-1, nfolds=0,
        weights_column=None, fold_column=None, ignored_columns=None,
        fold_assignment="auto",
    )
    _NO_CV = ("the reference's ANOVA-GLM cross-validation fails (its fold "
              "frames lack the interaction columns: KeyError; ROADMAP C)")
    PORTED = frozenset(DEFAULTS) - {"nfolds", "fold_column",
                                    "fold_assignment"}
    UNPORTED_WHY = {**ModelBuilder.UNPORTED_WHY, "nfolds": _NO_CV,
                    "fold_column": _NO_CV, "fold_assignment": _NO_CV}

    def __init__(self, **params):
        if "Lambda" in params:
            params["lambda_"] = params.pop("Lambda")
        super().__init__(**params)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        category = infer_category(frame, y)
        family = _family(p, category, "ANOVAGLM")
        glm_kw = _glm_kw(p)
        terms: List[tuple] = [(n,) for n in x]
        if int(p["highest_interaction_term"]) >= 2:
            numeric = [n for n in x if not frame.col(n).is_categorical]
            terms += list(combinations(numeric, 2))
        work = with_products(frame, [t for t in terms if len(t) == 2])
        term_cols = {t: [":".join(t)] for t in terms}
        all_cols = [c for cols in term_cols.values() for c in cols]
        full = _fit_glm(work, all_cols, y, family, **glm_kw)
        dev_full = _resid_deviance(full)
        table: List[dict] = []
        for t in terms:
            red = _fit_glm(work, [c for c in all_cols
                                  if c not in term_cols[t]],
                           y, family, **glm_kw)
            # df = the coefficients the term adds
            df = (frame.col(t[0]).cardinality - 1
                  if len(t) == 1 and frame.col(t[0]).is_categorical else 1)
            lr = max(_resid_deviance(red) - dev_full, 0.0)
            table.append({"term": ":".join(t), "df": df, "deviance": lr,
                          "p_value": _chi2_sf(lr, df)})
        output = {"category": category, "response": y, "names": list(x),
                  "domain": frame.col(y).domain, "anova_table": table,
                  "full_deviance": dev_full, "n_glm_fits": len(terms) + 1}
        model = ANOVAGLMModel(p, output, full)
        model.training_metrics = full.training_metrics
        return model


class ModelSelectionModel(Model):
    algo = "modelselection"

    def __init__(self, params, output, best_models: Dict[int, Model]):
        super().__init__(params, output)
        self.best_models = best_models

    def _score_raw(self, frame):
        return self.best_models[max(self.best_models)]._score_raw(frame)

    def model_performance(self, frame, mask_weights=None):
        return self.best_models[max(self.best_models)].model_performance(
            frame, mask_weights)

    def result(self) -> List[dict]:
        return self.output["best_per_size"]

    def coef(self, size: int) -> Dict[str, float]:
        return self.best_models[size].coefficients


class ModelSelectionEstimator(ModelBuilder):
    """h2o-py H2OModelSelectionEstimator surface
    (h2o-py/h2o/estimators/model_selection.py): the best GLM per
    predictor count, modes maxr / allsubsets / forward / backward."""

    algo = "modelselection"
    label = "ModelSelection"

    DEFAULTS = dict(
        mode="maxr", max_predictor_number=0, min_predictor_number=1,
        family="auto", link=None, lambda_=0.0, alpha=0.0,
        standardize=True, max_iterations=50, seed=-1, nfolds=0,
        weights_column=None, fold_column=None, ignored_columns=None,
        fold_assignment="auto", p_values_threshold=0.0,
    )
    PORTED = frozenset(DEFAULTS)

    def __init__(self, **params):
        if "Lambda" in params:
            params["lambda_"] = params.pop("Lambda")
        super().__init__(**params)

    @staticmethod
    def _r2(m: Model) -> float:
        d = m.training_metrics.to_dict()
        return d.get("r2", -d.get("logloss", np.inf))

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        category = infer_category(frame, y)
        family = _family(p, category, "ModelSelection", default="gaussian")
        glm_kw = _glm_kw(p)
        mode = str(p["mode"]).lower()
        kmax = min(int(p["max_predictor_number"]) or len(x), len(x))
        kmin = max(1, int(p["min_predictor_number"]))
        r2 = self._r2
        best_models: Dict[int, Model] = {}
        best_sets: Dict[int, List[str]] = {}
        n_fits = 0

        def fit(subset) -> Model:
            nonlocal n_fits
            n_fits += 1
            return _fit_glm(frame, list(subset), y, family, **glm_kw)

        if mode == "allsubsets":
            if len(x) > 16:
                raise ValueError("allsubsets limited to <=16 predictors")
            for k in range(kmin, kmax + 1):
                best, bs = None, None
                for sub in combinations(x, k):
                    m = fit(sub)
                    if best is None or r2(m) > r2(best):
                        best, bs = m, list(sub)
                best_models[k], best_sets[k] = best, bs
        elif mode == "backward":
            cur = list(x)
            m = fit(cur)
            if len(cur) <= kmax:
                best_models[len(cur)], best_sets[len(cur)] = m, list(cur)
            while len(cur) > kmin:
                best, bs = None, None
                for drop in cur:
                    sub = [c for c in cur if c != drop]
                    m = fit(sub)
                    if best is None or r2(m) > r2(best):
                        best, bs = m, sub
                cur = bs
                if len(cur) <= kmax:
                    best_models[len(cur)], best_sets[len(cur)] = best, cur
        else:   # forward, and maxr: forward with a replacement sweep
            cur: List[str] = []
            while len(cur) < kmax:
                best, bs = None, None
                for add in [c for c in x if c not in cur]:
                    m = fit(cur + [add])
                    if best is None or r2(m) > r2(best):
                        best, bs = m, cur + [add]
                cur = bs
                if mode == "maxr" and len(cur) > 1:
                    # swap each member for each non-member while that
                    # improves (hex/modelselection maxr)
                    improved = True
                    while improved:
                        improved = False
                        for i, _ in enumerate(list(cur)):
                            for cand in [c for c in x if c not in cur]:
                                sub = list(cur)
                                sub[i] = cand
                                m = fit(sub)
                                if r2(m) > r2(best):
                                    best, cur, improved = m, sub, True
                if len(cur) >= kmin:
                    best_models[len(cur)] = best
                    best_sets[len(cur)] = list(cur)

        table = [{"size": k, "predictors": best_sets[k],
                  "r2": r2(best_models[k])} for k in sorted(best_models)]
        output = {"category": category, "response": y, "names": list(x),
                  "domain": frame.col(y).domain, "best_per_size": table,
                  "n_glm_fits": n_fits}
        model = ModelSelectionModel(p, output, best_models)
        model.training_metrics = best_models[max(best_models)] \
            .training_metrics
        return model
