"""Infogram — admissible-ML feature screening.

Reference: h2o3_tpu/models/infogram.py (h2o-admissibleml,
hex/Infogram/Infogram.java). For every predictor: its relevance, the
scaled variable importance of a GBM on all predictors; and its net
information (cmi), a training-logloss difference of probe GBMs scaled
to the largest. The core infogram conditions on the other predictors
(the loss the predictor's removal costs); the fair infogram conditions
on the ``protected_columns`` (the loss its addition to them saves).
Admissible features clear both thresholds.

Every model is the port's ``GBMEstimator`` (``ntrees``, ``max_depth``,
the seed), so on the card each probe launches the level kernels. Only
the ``ntop`` most relevant predictors are probed; the rest score cmi 0.

Not ported: ``fold_column`` (with it the reference runs its generic
cross-validation on a screening model that scores nothing), a
partitioned frame (ROADMAP A #12). ``nfolds`` >= 2 raises, as in the
reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, infer_category,
                                         require_local)


def _probe_logloss(frame: Frame, feats, y: str, ntrees: int, depth: int,
                   seed: int) -> float:
    """The training logloss (or the first of mean per-class error and
    MSE the metrics have) of a shallow GBM on ``feats``: the CMI
    estimator's probe."""
    from h2o3_tpu_torch.models.gbm import GBMEstimator
    m = GBMEstimator(ntrees=ntrees, max_depth=depth, seed=seed).train(
        frame, y=y, x=list(feats))
    tm = m.training_metrics.to_dict()
    for k in ("logloss", "mean_per_class_error", "MSE"):
        if tm.get(k) is not None:
            return float(tm[k])
    return float("nan")


class InfogramModel(Model):
    algo = "infogram"

    def __init__(self, params, output, device):
        super().__init__(params, output)
        self.device = device

    @property
    def admissible_features(self) -> List[str]:
        return self.output["admissible_features"]

    def get_admissible_score_frame(self) -> Frame:
        t = self.output["infogram_table"]
        return Frame.from_numpy({
            "column": np.asarray([r["column"] for r in t], dtype=object),
            "admissible": np.asarray(
                [1.0 if r["admissible"] else 0.0 for r in t]),
            "admissible_index": np.asarray(
                [r["admissible_index"] for r in t]),
            "relevance_index": np.asarray([r["relevance"] for r in t]),
            "safety_index": np.asarray([r["cmi"] for r in t]),
        }, categorical=["column"], device=self.device)

    def _score_raw(self, frame: Frame):
        raise NotImplementedError("Infogram is a screening model")

    def model_performance(self, frame: Frame, mask_weights=None):
        return None


class InfogramEstimator(ModelBuilder):
    """h2o-py H2OInfogram surface (h2o-py/h2o/estimators/infogram.py)."""

    algo = "infogram"
    label = "Infogram"

    DEFAULTS = dict(
        protected_columns=None, safety_index_threshold=0.1,
        relevance_index_threshold=0.1, net_information_threshold=-1.0,
        total_information_threshold=-1.0, ntop=50, seed=-1,
        ntrees=10, max_depth=5, ignored_columns=None, nfolds=0,
        fold_assignment="auto", weights_column=None, fold_column=None,
    )
    PORTED = frozenset(DEFAULTS) - {"fold_column"}
    UNPORTED_WHY = {**ModelBuilder.UNPORTED_WHY, "fold_column":
                    "with it the reference runs generic cross-validation "
                    "on a screening model that scores nothing"}

    def __init__(self, **params):
        if int(params.get("nfolds") or 0) >= 2:
            raise ValueError("Infogram is a screening model; generic CV is "
                             "not applicable (nfolds must be 0)")
        super().__init__(**params)

    def resolve_x(self, frame, x, y):
        x = super().resolve_x(frame, x, y)
        protected = set(self.params.get("protected_columns") or [])
        return [n for n in x if n not in protected]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        from h2o3_tpu_torch.models.gbm import GBMEstimator
        require_local(frame, self.label)
        p = self.params
        protected = list(p.get("protected_columns") or [])
        ntrees, depth = int(p["ntrees"]), int(p["max_depth"])
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0x1F06

        # relevance: the scaled importance of a GBM on all predictors
        full = GBMEstimator(ntrees=ntrees, max_depth=depth, seed=seed).train(
            frame, y=y, x=list(x))
        vi = {name: rel for name, _, rel, _ in
              (full.output.get("varimp") or [])}
        relevance = np.asarray([vi.get(f, 0.0) for f in x])
        # the probes cover the ntop most relevant predictors
        ntop = int(p["ntop"])
        probe_set = set(np.asarray(list(x))[np.argsort(-relevance)[:ntop]])

        probe = lambda feats: _probe_logloss(  # noqa: E731
            frame, feats, y, ntrees, depth, seed)
        cmi_raw = np.zeros(len(x))
        n_probes = 1
        if protected:
            # fair infogram: what adding x_i to the protected set saves
            base = probe(protected)
            for i, f in enumerate(x):
                if f in probe_set:
                    cmi_raw[i] = max(base - probe(protected + [f]), 0.0)
                    n_probes += 1
        else:
            # core infogram: what dropping x_i from the rest costs
            base = probe(x)
            for i, f in enumerate(x):
                if f not in probe_set:
                    continue
                rest = [c for c in x if c != f]
                if not rest:
                    cmi_raw[i] = 1.0
                    continue
                cmi_raw[i] = max(probe(rest) - base, 0.0)
                n_probes += 1
        cmi = cmi_raw / max(cmi_raw.max(), 1e-12)

        rel_thr = float(p["relevance_index_threshold"])
        if float(p["total_information_threshold"]) >= 0:
            rel_thr = float(p["total_information_threshold"])
        saf_thr = float(p["safety_index_threshold"])
        if float(p["net_information_threshold"]) >= 0:
            saf_thr = float(p["net_information_threshold"])

        table = []
        for i, f in enumerate(x):
            table.append({
                "column": f, "relevance": float(relevance[i]),
                "cmi": float(cmi[i]), "cmi_raw": float(cmi_raw[i]),
                "admissible": bool(relevance[i] >= rel_thr
                                   and cmi[i] >= saf_thr),
                "admissible_index": float(
                    np.hypot(relevance[i], cmi[i]) / np.sqrt(2.0)),
            })
        table.sort(key=lambda r: -r["admissible_index"])
        admissible = [r["column"] for r in table if r["admissible"]][:ntop]
        output = {"category": infer_category(frame, y), "response": y,
                  "names": list(x), "domain": frame.col(y).domain,
                  "infogram_table": table,
                  "admissible_features": admissible,
                  "protected_columns": protected,
                  "gbm_fits": 1 + n_probes}
        return InfogramModel(p, output, frame.device)
