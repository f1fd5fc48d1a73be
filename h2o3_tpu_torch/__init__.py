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
    mlp = h2o.DeepLearningEstimator(hidden=[200, 200], epochs=8,
                                    seed=1).train(fr, y="label")
    ae = h2o.DeepLearningEstimator(autoencoder=True).train(fr)
    ae.anomaly(fr)
    km = h2o.KMeansEstimator(k=10, init="Furthest").train(fr)   # y=None
    pc = h2o.PCAEstimator(k=5, transform="standardize").train(fr)
    lr = h2o.GLRMEstimator(k=4, transform="standardize").train(fr)
    nb = h2o.NaiveBayesEstimator(laplace=1).train(fr, y="label")
    te = h2o.TargetEncoderEstimator(blending=True).train(fr, y="label")
    te.transform(fr)                      # appends <col>_te columns
    gam = h2o.GAMEstimator(gam_columns=["x0"]).train(fr, y="label")
    rf = h2o.RuleFitEstimator(max_rule_length=3).train(fr, y="label")
    rf.rule_importance
    sel = h2o.ModelSelectionEstimator(mode="maxr").train(fr, y="label")
    sel.result()
    av = h2o.ANOVAGLMEstimator().train(fr, y="label"); av.anova_table
    iso = h2o.IsotonicRegressionEstimator().train(fr, y="delay",
                                                  x=["DepTime"])
    ig = h2o.InfogramEstimator().train(fr, y="label")
    ig.admissible_features
    cox = h2o.CoxPHEstimator(stop_column="t", start_column="t0",
                             stratify_by=["site"]).train(fr, y="event")
    sv = h2o.PSVMEstimator(hyper_param=1.0).train(fr, y="label")
    ag = h2o.AggregatorEstimator(target_num_exemplars=5000).train(fr)
    ag.aggregated_frame
    w2v = h2o.Word2VecEstimator(vec_size=100).train(words_fr)
    w2v.find_synonyms("king"); w2v.transform(words_fr, "AVERAGE")
    from h2o3_tpu_torch.frame.quantiles import frame_quantiles
    from h2o3_tpu_torch.ops.sort import device_sort, device_join_index
    h2o.models.get_builder("gbm")         # the algorithm registry
    fr = h2o.import_file("airlines.csv", destination_frame="air")  # DKV key
    grid = h2o.GridSearch(h2o.GBMEstimator, {"max_depth": [3, 6]},
                          ntrees=20).train(fr, y="label")
    grid.sorted_models()
    se = h2o.StackedEnsembleEstimator(base_models=[m1, m2]).train(
        fr, y="label")                    # m1, m2 trained with nfolds
    aml = h2o.H2OAutoML(max_models=20, nfolds=3, seed=1,
                        max_runtime_secs=300)
    aml.train(y="label", training_frame=fr); aml.leaderboard.as_table()
    ref = h2o.upload_custom_distribution(MyLoss())   # "python:<key>"
    h2o.GBMEstimator(distribution="custom", custom_distribution_func=ref)
    job = h2o.GBMEstimator().train(fr, y="label", background=True)
    job.join().result                     # core/job.Job

Entry points default to ``torch.device("cuda")`` and raise when no card
is present; pass ``device="cpu"`` to run the plain versions on the CPU.
"""

from h2o3_tpu_torch.automl import H2OAutoML
from h2o3_tpu_torch.core.kv import DKV
from h2o3_tpu_torch.core.udf import (upload_custom_distribution,
                                     upload_custom_metric)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.io.parser import import_file
from h2o3_tpu_torch.ml.ensemble import StackedEnsembleEstimator
from h2o3_tpu_torch.ml.grid import GridSearch
from h2o3_tpu_torch.models.aggregator import AggregatorEstimator
from h2o3_tpu_torch.models.coxph import CoxPHEstimator
from h2o3_tpu_torch.models.deeplearning import DeepLearningEstimator
from h2o3_tpu_torch.models.drf import DRFEstimator
from h2o3_tpu_torch.models.extisofor import ExtendedIsolationForestEstimator
from h2o3_tpu_torch.models.gam import GAMEstimator
from h2o3_tpu_torch.models.gbm import GBMEstimator
from h2o3_tpu_torch.models.glm import GLMEstimator
from h2o3_tpu_torch.models.glrm import GLRMEstimator
from h2o3_tpu_torch.models.infogram import InfogramEstimator
from h2o3_tpu_torch.models.isofor import IsolationForestEstimator
from h2o3_tpu_torch.models.isotonic import IsotonicRegressionEstimator
from h2o3_tpu_torch.models.kmeans import KMeansEstimator
from h2o3_tpu_torch.models.model_selection import (ANOVAGLMEstimator,
                                                   ModelSelectionEstimator)
from h2o3_tpu_torch.models.naivebayes import NaiveBayesEstimator
from h2o3_tpu_torch.models.pca import PCAEstimator, SVDEstimator
from h2o3_tpu_torch.models.psvm import PSVMEstimator
from h2o3_tpu_torch.models.rulefit import RuleFitEstimator
from h2o3_tpu_torch.models.targetencoder import TargetEncoderEstimator
from h2o3_tpu_torch.models.uplift import UpliftDRFEstimator
from h2o3_tpu_torch.models.word2vec import Word2VecEstimator
from h2o3_tpu_torch.models.xgboost import XGBoostEstimator

__all__ = ["DKV", "Frame", "GridSearch", "H2OAutoML", "import_file",
           "StackedEnsembleEstimator", "upload_custom_distribution",
           "upload_custom_metric", "AggregatorEstimator",
           "ANOVAGLMEstimator", "CoxPHEstimator", "DeepLearningEstimator", "DRFEstimator",
           "ExtendedIsolationForestEstimator", "GAMEstimator", "GBMEstimator",
           "GLMEstimator", "GLRMEstimator", "InfogramEstimator",
           "IsolationForestEstimator", "IsotonicRegressionEstimator",
           "KMeansEstimator", "ModelSelectionEstimator",
           "NaiveBayesEstimator", "PCAEstimator", "PSVMEstimator",
           "RuleFitEstimator", "SVDEstimator", "TargetEncoderEstimator",
           "UpliftDRFEstimator", "Word2VecEstimator", "XGBoostEstimator"]
