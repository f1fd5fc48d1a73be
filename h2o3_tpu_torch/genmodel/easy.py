"""EasyPredictModelWrapper — labeled, typed single-row predictions.

The port's copy of h2o3_tpu/genmodel/easy.py; the port imports nothing
of the reference package, so it keeps its own.

Reference: hex/genmodel/easy/EasyPredictModelWrapper.java + the typed
prediction classes (BinomialModelPrediction, RegressionModelPrediction,
...) under hex/genmodel/easy/prediction/.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from h2o3_tpu_torch.genmodel.readers import MojoModel


@dataclass
class BinomialModelPrediction:
    label: str
    label_index: int
    class_probabilities: List[float]


@dataclass
class MultinomialModelPrediction:
    label: str
    label_index: int
    class_probabilities: List[float]


@dataclass
class RegressionModelPrediction:
    value: float


@dataclass
class ClusteringModelPrediction:
    cluster: int


@dataclass
class AnomalyDetectionPrediction:
    score: float
    normalized_score: float = 0.0


class EasyPredictModelWrapper:
    """Row-dict in, typed prediction out."""

    def __init__(self, model: MojoModel):
        self.model = model

    def _score(self, row: dict) -> dict:
        return self.model.score0(row)

    def predict(self, row: dict):
        cat = self.model.category
        if cat == "Binomial":
            return self.predict_binomial(row)
        if cat == "Multinomial":
            return self.predict_multinomial(row)
        if cat == "Clustering":
            return self.predict_clustering(row)
        if cat == "AnomalyDetection":
            return self.predict_anomaly_detection(row)
        return self.predict_regression(row)

    def predict_binomial(self, row: dict) -> BinomialModelPrediction:
        out = self._score(row)
        idx = int(out["predict"])
        dom = self.model.domain or ["0", "1"]
        return BinomialModelPrediction(
            label=dom[idx], label_index=idx,
            class_probabilities=[float(out["p0"]), float(out["p1"])])

    def predict_multinomial(self, row: dict) -> MultinomialModelPrediction:
        out = self._score(row)
        idx = int(out["predict"])
        dom = self.model.domain or [str(i) for i in range(self.model.nclasses)]
        probs = [float(out[f"p{k}"]) for k in range(self.model.nclasses)]
        return MultinomialModelPrediction(label=dom[idx], label_index=idx,
                                          class_probabilities=probs)

    def predict_regression(self, row: dict) -> RegressionModelPrediction:
        return RegressionModelPrediction(value=float(self._score(row)["predict"]))

    def predict_clustering(self, row: dict) -> ClusteringModelPrediction:
        return ClusteringModelPrediction(cluster=int(self._score(row)["predict"]))

    def predict_anomaly_detection(self, row: dict) -> AnomalyDetectionPrediction:
        out = self._score(row)
        return AnomalyDetectionPrediction(score=float(out["predict"]),
                                          normalized_score=float(out["predict"]))

    def predict_contributions(self, row: dict) -> Dict[str, float]:
        """Per-feature TreeSHAP contributions + BiasTerm
        (EasyPredictModelWrapper.predictContributions role)."""
        batch = {k: np.asarray([v]) for k, v in row.items()}
        out = self.model.predict_contributions(batch)
        return {k: float(v[0]) for k, v in out.items()}
