"""AutoML modeling-step providers — the ai.h2o.automl.modeling system.

Reference: h2o3_tpu/automl/steps.py, the port's own copy, equal field by
field. The reference's source: one StepsProvider per algo under
h2o-automl/src/main/java/ai/h2o/automl/modeling/ (e.g.
GBMStepsProvider.java: five prescribed defaults + a random grid;
DRFStepsProvider.java: def + XRT variant; DeepLearningStepsProvider:
def + three grids; XGBoostStepsProvider: three defaults + grid;
StackedEnsembleStepsProvider: best-of-family + all), executed by
ModelingStepsExecutor in priority groups (AutoML.java:420 planWork /
:760 learn): defaults → grids → exploitation (lr-annealing etc.) →
ensembles.

Each Step is declarative; ``automl/executor.py`` owns the budget
accounting (max_models / max_runtime_secs / the per-model cap) and
``automl/__init__.py`` the CV wiring.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Step:
    provider: str                 # "GBM", "DRF", ...
    id: str                       # step name, e.g. "GBM_2"
    algo: str                     # builder algo key
    kind: str = "default"         # default | grid | exploitation | ensemble
    params: Dict = dataclasses.field(default_factory=dict)
    hyper: Optional[Dict] = None  # grid hyper space (kind == "grid")
    grid_models: int = 5          # budget share for a grid step
    group: int = 1                # execution priority group


def glm_steps(seed: int) -> List[Step]:
    """GLMStepsProvider: one default with lambda search over alphas."""
    return [Step("GLM", "GLM_1", "glm", "default",
                 {"lambda_search": True, "nlambdas": 10,
                  "alpha": 0.5, "seed": seed}, group=1)]


def gbm_steps(seed: int) -> List[Step]:
    """GBMStepsProvider: 5 prescribed defaults (depth/sample shapes),
    then one random grid, then an lr-annealing exploitation step."""
    common = {"sample_rate": 0.8, "col_sample_rate_per_tree": 0.8,
              "score_tree_interval": 5, "ntrees": 100,
              "stopping_rounds": 3}
    defs = [
        Step("GBM", "GBM_1", "gbm", "default",
             {**common, "max_depth": 6, "min_rows": 1.0, "seed": seed},
             group=1),
        Step("GBM", "GBM_2", "gbm", "default",
             {**common, "max_depth": 7, "min_rows": 10.0, "seed": seed},
             group=2),
        Step("GBM", "GBM_3", "gbm", "default",
             {**common, "max_depth": 8, "min_rows": 10.0, "seed": seed},
             group=2),
        Step("GBM", "GBM_4", "gbm", "default",
             {**common, "max_depth": 10, "min_rows": 10.0, "seed": seed},
             group=3),
        Step("GBM", "GBM_5", "gbm", "default",
             {**common, "max_depth": 15, "min_rows": 100.0, "seed": seed},
             group=3),
    ]
    grid = Step("GBM", "GBM_grid_1", "gbm", "grid",
                {"ntrees": 60, "score_tree_interval": 5,
                 "stopping_rounds": 3, "seed": seed},
                hyper={"max_depth": [3, 4, 5, 6, 7, 8, 9, 10, 12, 15],
                       "min_rows": [1.0, 5.0, 10.0, 15.0, 30.0, 100.0],
                       "learn_rate": [0.01, 0.05, 0.08, 0.1, 0.15, 0.2],
                       "sample_rate": [0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
                       "col_sample_rate_per_tree":
                           [0.4, 0.7, 1.0]},
                grid_models=6, group=4)
    # exploitation: anneal the learn rate of the best GBM so far
    # (ai/h2o/automl/modeling/GBMStepsProvider lr_annealing step)
    explo = Step("GBM", "GBM_lr_annealing", "gbm", "exploitation",
                 {"seed": seed}, group=6)
    return defs + [grid, explo]


def drf_steps(seed: int) -> List[Step]:
    """DRFStepsProvider: default forest + the XRT variant (extremely
    randomized trees: random-split histograms,
    DRFStepsProvider.java XRT step)."""
    return [
        Step("DRF", "DRF_1", "drf", "default",
             {"ntrees": 50, "max_depth": 20, "seed": seed}, group=2),
        Step("DRF", "XRT_1", "drf", "default",
             {"ntrees": 50, "max_depth": 20, "seed": seed,
              "histogram_type": "random"}, group=3),
    ]


def deeplearning_steps(seed: int) -> List[Step]:
    """DeepLearningStepsProvider: one default + three grids over
    architecture/regularization."""
    return [
        Step("DeepLearning", "DeepLearning_1", "deeplearning", "default",
             {"hidden": [64, 64], "epochs": 10, "seed": seed,
              "stopping_rounds": 3}, group=3),
        Step("DeepLearning", "DeepLearning_grid_1", "deeplearning", "grid",
             {"epochs": 10, "seed": seed, "stopping_rounds": 3},
             hyper={"hidden": [[32], [64], [128], [32, 32], [64, 64],
                               [128, 128]],
                    "input_dropout_ratio": [0.0, 0.05, 0.1],
                    "rate": [0.005, 0.01, 0.02]},
             grid_models=3, group=4),
        Step("DeepLearning", "DeepLearning_grid_2", "deeplearning", "grid",
             {"epochs": 10, "seed": seed + 1, "stopping_rounds": 3},
             hyper={"hidden": [[64, 64, 64], [128, 64, 32]],
                    "activation": ["rectifier", "tanh"],
                    "l1": [0.0, 1e-4], "l2": [0.0, 1e-4]},
             grid_models=3, group=5),
    ]


def xgboost_steps(seed: int) -> List[Step]:
    """XGBoostStepsProvider: three defaults + a random grid (the
    xgboost facade maps onto the histogram GBM)."""
    return [
        Step("XGBoost", "XGBoost_1", "xgboost", "default",
             {"ntrees": 100, "max_depth": 10, "min_rows": 5.0,
              "sample_rate": 0.6, "col_sample_rate_per_tree": 0.8,
              "seed": seed}, group=1),
        Step("XGBoost", "XGBoost_2", "xgboost", "default",
             {"ntrees": 100, "max_depth": 20, "min_rows": 10.0,
              "sample_rate": 0.6, "col_sample_rate_per_tree": 0.8,
              "seed": seed}, group=2),
        Step("XGBoost", "XGBoost_3", "xgboost", "default",
             {"ntrees": 100, "max_depth": 5, "min_rows": 3.0,
              "sample_rate": 0.8, "col_sample_rate_per_tree": 0.8,
              "seed": seed}, group=2),
        Step("XGBoost", "XGBoost_grid_1", "xgboost", "grid",
             {"ntrees": 60, "seed": seed},
             hyper={"max_depth": [3, 5, 7, 10, 15],
                    "min_rows": [1.0, 5.0, 10.0],
                    "sample_rate": [0.6, 0.8, 1.0],
                    "reg_lambda": [0.1, 1.0, 10.0]},
             grid_models=5, group=4),
    ]


def ensemble_steps(seed: int) -> List[Step]:
    """StackedEnsembleStepsProvider: best-of-family then all-models."""
    return [
        Step("StackedEnsemble", "StackedEnsemble_BestOfFamily",
             "stackedensemble", "ensemble", {}, group=9),
        Step("StackedEnsemble", "StackedEnsemble_AllModels",
             "stackedensemble", "ensemble", {}, group=10),
    ]


PROVIDERS = {
    "glm": glm_steps,
    "gbm": gbm_steps,
    "drf": drf_steps,
    "deeplearning": deeplearning_steps,
    "xgboost": xgboost_steps,
    "stackedensemble": ensemble_steps,
}


def modeling_plan(seed: int, include=None, exclude=None) -> List[Step]:
    """All steps from all providers, ordered by execution group —
    the planWork output (AutoML.java:420)."""
    steps: List[Step] = []
    for algo, provider in PROVIDERS.items():
        if include is not None and algo not in include:
            continue
        if exclude and algo in exclude:
            continue
        steps.extend(provider(seed))
    steps.sort(key=lambda s: s.group)
    return steps
