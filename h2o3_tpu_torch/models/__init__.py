"""Models of the PyTorch port, and the algorithm registry.

Reference: h2o3_tpu/models/__init__.py (hex/api/RegisterAlgos.java): every
ModelBuilder registers under its algo name, so later layers (grid search,
AutoML, REST) build estimators by name. Here the table is built from the
port's estimator modules at the first lookup. ``get_builder`` normalizes
a name as the reference does (lower case, no underscores). An algorithm
the reference has and the port does not yet raises
``NotImplementedError`` naming the ROADMAP item that ports it; an
unknown name raises ``ValueError``.
"""

from functools import lru_cache
from typing import Dict

# the reference's algorithms the port has not ported yet, by ROADMAP item
UNPORTED: Dict[str, str] = {}


@lru_cache(maxsize=None)
def _registry() -> Dict[str, type]:
    """The port's estimators by algo name, imported at the first lookup
    (the estimator modules import this package)."""
    from h2o3_tpu_torch.ml.ensemble import StackedEnsembleEstimator
    from h2o3_tpu_torch.models.aggregator import AggregatorEstimator
    from h2o3_tpu_torch.models.coxph import CoxPHEstimator
    from h2o3_tpu_torch.models.deeplearning import DeepLearningEstimator
    from h2o3_tpu_torch.models.drf import DRFEstimator
    from h2o3_tpu_torch.models.extisofor import \
        ExtendedIsolationForestEstimator
    from h2o3_tpu_torch.models.gam import GAMEstimator
    from h2o3_tpu_torch.models.gbm import GBMEstimator
    from h2o3_tpu_torch.models.generic import GenericEstimator
    from h2o3_tpu_torch.models.glm import GLMEstimator
    from h2o3_tpu_torch.models.glrm import GLRMEstimator
    from h2o3_tpu_torch.models.infogram import InfogramEstimator
    from h2o3_tpu_torch.models.isofor import IsolationForestEstimator
    from h2o3_tpu_torch.models.isotonic import IsotonicRegressionEstimator
    from h2o3_tpu_torch.models.kmeans import KMeansEstimator
    from h2o3_tpu_torch.models.model_selection import (
        ANOVAGLMEstimator, ModelSelectionEstimator)
    from h2o3_tpu_torch.models.naivebayes import NaiveBayesEstimator
    from h2o3_tpu_torch.models.pca import PCAEstimator, SVDEstimator
    from h2o3_tpu_torch.models.psvm import PSVMEstimator
    from h2o3_tpu_torch.models.rulefit import RuleFitEstimator
    from h2o3_tpu_torch.models.targetencoder import TargetEncoderEstimator
    from h2o3_tpu_torch.models.uplift import UpliftDRFEstimator
    from h2o3_tpu_torch.models.word2vec import Word2VecEstimator
    from h2o3_tpu_torch.models.xgboost import XGBoostEstimator
    return {cls.algo: cls for cls in (
        AggregatorEstimator, ANOVAGLMEstimator, CoxPHEstimator,
        DeepLearningEstimator, DRFEstimator,
        ExtendedIsolationForestEstimator, GAMEstimator, GBMEstimator,
        GenericEstimator, GLMEstimator, GLRMEstimator, InfogramEstimator,
        IsolationForestEstimator, IsotonicRegressionEstimator,
        KMeansEstimator, ModelSelectionEstimator, NaiveBayesEstimator,
        PCAEstimator, PSVMEstimator, RuleFitEstimator,
        StackedEnsembleEstimator, SVDEstimator, TargetEncoderEstimator, UpliftDRFEstimator, Word2VecEstimator,
        XGBoostEstimator)}


def get_builder(algo: str):
    """Builder class by algo name (ModelBuilder.make analogue)."""
    key = algo.lower().replace("_", "")
    reg = _registry()
    if key in reg:
        return reg[key]
    if key in UNPORTED:
        raise NotImplementedError(
            f"algo '{algo}' is not ported yet (ROADMAP {UNPORTED[key]})")
    raise ValueError(f"unknown algo '{algo}'; have {sorted(reg)}")


def all_algos():
    return sorted(_registry())
