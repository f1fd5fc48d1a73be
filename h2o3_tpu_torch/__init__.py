"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu, on one NVIDIA H100.

The JAX package ``h2o3_tpu`` is the reference; this package mirrors its
module names (``frame/``, ``ops/``, ``models/``) and never imports it or
JAX. Its TPU kernels are hand-written CUDA kernels under
``ops/kernels/csrc``, each with a plain PyTorch version beside it.

    import h2o3_tpu_torch as h2o
    fr = h2o.import_file("airlines.csv")                     # on the card
    fr = h2o.Frame.from_numpy({...}, domains={...})        # or from numpy
    m = h2o.GBMEstimator(ntrees=10, max_depth=6).train(fr, y="label")
    preds = m.predict(fr)
    rf = h2o.DRFEstimator(ntrees=10, max_depth=10).train(fr, y="label")
    up = h2o.UpliftDRFEstimator(treatment_column="treatment").train(
        fr, y="visit")
    xg = h2o.XGBoostEstimator(nrounds=10, eta=0.1).train(fr, y="label")
    iso = h2o.IsolationForestEstimator(ntrees=50).train(fr)
    m.predict_contributions(fr); m.predict_leaf_node_assignment(fr)
    glm = h2o.GLMEstimator(family="binomial", lambda_=0.0,
                           solver="irlsm").train(fr, y="label")
    glm.coefficients; glm.predict(fr)
    net = h2o.GLMEstimator(alpha=0.5, lambda_search=True,
                           nlambdas=30).train(fr, y="delay")

Entry points default to ``torch.device("cuda")`` and raise when no card
is present; pass ``device="cpu"`` to run the plain versions on the CPU.
"""

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.io.parser import import_file
from h2o3_tpu_torch.models.drf import DRFEstimator
from h2o3_tpu_torch.models.extisofor import ExtendedIsolationForestEstimator
from h2o3_tpu_torch.models.gbm import GBMEstimator
from h2o3_tpu_torch.models.glm import GLMEstimator
from h2o3_tpu_torch.models.isofor import IsolationForestEstimator
from h2o3_tpu_torch.models.uplift import UpliftDRFEstimator
from h2o3_tpu_torch.models.xgboost import XGBoostEstimator

__all__ = ["Frame", "import_file", "DRFEstimator",
           "ExtendedIsolationForestEstimator", "GBMEstimator", "GLMEstimator",
           "IsolationForestEstimator", "UpliftDRFEstimator",
           "XGBoostEstimator"]
