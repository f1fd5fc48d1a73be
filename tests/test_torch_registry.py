"""The port's algorithm registry (``h2o3_tpu_torch.models``) against the
reference's: every algorithm the port has is found under the same names
(the reference's normalization: case and underscores), no algorithm of
the reference is left unported (``UNPORTED`` is empty since ``generic``
came), and an unknown name raises ``ValueError`` in both. The
port also registers ``stackedensemble`` (its AutoML and grid build every
estimator by name), which the reference's table leaves out: it is the
builder of the reference's ``ml/ensemble.py``, mirrored."""

import pytest

from h2o3_tpu import models as ref_models
from h2o3_tpu_torch import models
from torch_threads import one_torch_thread  # noqa: F401 - autouse


def test_every_ported_name_finds_the_references_estimator():
    from h2o3_tpu.ml.ensemble import StackedEnsembleEstimator as RefSE
    for algo in models.all_algos():
        port = models.get_builder(algo)
        ref = RefSE if algo == "stackedensemble" else \
            ref_models.get_builder(algo)
        assert port.algo == ref.algo == algo
        assert port.__name__ == ref.__name__
        assert port.__module__.replace("h2o3_tpu_torch.", "") == \
            ref.__module__.replace("h2o3_tpu.", "")
    assert models.all_algos() == sorted(
        ["aggregator", "anovaglm", "coxph", "deeplearning", "drf",
         "extendedisolationforest", "gam", "gbm", "generic", "glm", "glrm",
         "infogram", "isolationforest", "isotonicregression", "kmeans",
         "modelselection", "naivebayes", "pca", "psvm", "rulefit",
         "stackedensemble", "svd", "targetencoder", "upliftdrf", "word2vec",
         "xgboost"])
    assert not {"kmeans", "pca", "svd", "glrm", "naivebayes",
                "targetencoder", "gam", "rulefit", "modelselection",
                "anovaglm", "isotonicregression", "infogram", "coxph",
                "psvm", "aggregator", "word2vec", "generic",
                "stackedensemble"} & set(models.UNPORTED)
    assert set(models.UNPORTED) == set()


@pytest.mark.parametrize("name", ["Deep_Learning", "DEEPLEARNING", "gbm",
                                  "Uplift_DRF", "isolation_forest",
                                  "extended_isolation_forest", "XGBoost",
                                  "K_Means", "PCA", "SVD", "GLRM",
                                  "Naive_Bayes", "Target_Encoder", "GAM",
                                  "Rule_Fit", "Model_Selection",
                                  "ANOVA_GLM", "Isotonic_Regression",
                                  "InfoGram", "CoxPH", "PSVM",
                                  "Aggregator", "Word2Vec", "word_2_vec",
                                  "Generic"])
def test_names_normalize_as_in_the_reference(name):
    assert models.get_builder(name).algo == \
        ref_models.get_builder(name).algo


@pytest.mark.parametrize("name", ["Stacked_Ensemble", "StackedEnsemble",
                                  "stackedensemble"])
def test_stacked_ensemble_is_registered(name):
    from h2o3_tpu_torch.ml.ensemble import StackedEnsembleEstimator
    assert models.get_builder(name) is StackedEnsembleEstimator
    with pytest.raises(ValueError, match="unknown algo"):
        ref_models.get_builder(name)


def test_the_rest_of_the_reference_is_named_and_unported():
    rest = set(ref_models.all_algos()) - set(models.all_algos())
    assert rest == set(models.UNPORTED) == set()
    from h2o3_tpu_torch.models.generic import GenericEstimator
    assert models.get_builder("generic") is GenericEstimator


@pytest.mark.parametrize("name", ["nope", "gbm2", "deep learning"])
def test_unknown_names_raise_value_error_in_both(name):
    for reg in (models, ref_models):
        with pytest.raises(ValueError, match=f"unknown algo '{name}'"):
            reg.get_builder(name)
