"""Carry trained forests across from the reference package's numpy images.

``gbm_model_from_arrays`` (a reference XGBoost model is a GBM model and
comes across by it), ``drf_model_from_arrays``,
``uplift_model_from_arrays``, ``isofor_model_from_arrays`` and
``extisofor_model_from_arrays`` build port models from plain numpy arrays
and lists — every ``Tree`` field of the stacked forest, the training
binning (``edges``, ``nbins``, ``is_cat``, ``names``, ``domains``,
``nbins_total``, ``nbins_cats``) and the model's own fields — so both
packages score the same forest. What a ``checkpoint`` restart reads comes
across too: the training ``params`` (the non-modifiable fields are
checked against them), GBM's f0 and ``init_f``, DRF's out-of-bag
accumulators; and a calibrator. ``glm_model_from_arrays`` carries a GLM
across: its coefficients, family and design statistics;
``deeplearning_model_from_arrays`` a DeepLearning net with its design
statistics and its optimizer state and step count (what ``checkpoint=``
continues from). ``kmeans_model_from_arrays``, ``pca_model_from_arrays``,
``svd_model_from_arrays``, ``glrm_model_from_arrays``,
``naivebayes_model_from_arrays`` and ``targetencoder_model_from_arrays``
carry the unsupervised and count-based models across: their centers,
eigenvectors, singular vectors or archetypes with the design statistics,
or their statistics and encoding maps. ``gam_model_from_arrays``,
``rulefit_model_from_arrays``, ``anovaglm_model_from_arrays``,
``modelselection_model_from_arrays`` and ``isotonic_model_from_arrays``
carry the GLM wrappers and Isotonic Regression across: a GAM's
coefficients with its knots and centering means, RuleFit's tree models,
GLM, rules and winsor bounds, the wrappers' GLMs, Isotonic's thresholds.
``coxph_model_from_arrays``, ``psvm_model_from_arrays`` and
``word2vec_model_from_arrays`` carry CoxPH's coefficients, PSVM's
feature map and weights, and Word2Vec's vectors across (an Aggregator
scores nothing and carries nothing across). A GBM, DRF, GLM or
DeepLearning model trained with cross-validation brings its holdout
predictions and fold ids (``cv_holdout``, ``cv_folds``: what a
StackedEnsemble stacks). Nothing here imports the reference package:
the caller hands over numpy.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import BinnedMatrix
from h2o3_tpu_torch.ml.calibration import Calibrator
from h2o3_tpu_torch.models.coxph import CoxPHModel
from h2o3_tpu_torch.models.deeplearning import DeepLearningModel
from h2o3_tpu_torch.models.drf import DRFModel
from h2o3_tpu_torch.models.extisofor import (ExtendedIsolationForestModel,
                                             ExtTree)
from h2o3_tpu_torch.models.gam import GAMModel
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.glm import Family, GLMModel
from h2o3_tpu_torch.models.glrm import GLRMModel
from h2o3_tpu_torch.models.isofor import ANOMALY, IsolationForestModel
from h2o3_tpu_torch.models.isotonic import IsotonicRegressionModel
from h2o3_tpu_torch.models.kmeans import KMeansModel
from h2o3_tpu_torch.models.model_selection import (ANOVAGLMModel,
                                                   ModelSelectionModel)
from h2o3_tpu_torch.models.naivebayes import NaiveBayesModel
from h2o3_tpu_torch.models.pca import PCAModel, SVDModel
from h2o3_tpu_torch.models.psvm import PSVMModel
from h2o3_tpu_torch.models.rulefit import RuleFitModel
from h2o3_tpu_torch.models.targetencoder import TargetEncoderModel
from h2o3_tpu_torch.models.tree import Tree, keep_layout
from h2o3_tpu_torch.models.uplift import UpliftDRFModel
from h2o3_tpu_torch.models.word2vec import Word2VecModel
from h2o3_tpu_torch.parallel.device import DeviceLike, resolve_device

Arrays = Dict[str, Union[np.ndarray, List]]

_TREE_DTYPES = {"feat": torch.int32, "thresh": torch.int32,
                "na_left": torch.bool, "is_split": torch.bool,
                "leaf": torch.float32, "leaf_w": torch.float32,
                "cat_split": torch.bool, "left_words": torch.int32}


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def _forest(d: Arrays, dev) -> Tree:
    fields = {}
    for f in Tree._fields:
        a = np.ascontiguousarray(np.asarray(d[f]))
        if f == "left_words":
            a = a.astype(np.uint32).view(np.int32)   # same bit pattern
        fields[f] = torch.from_numpy(a.copy()).to(dev, _TREE_DTYPES[f])
    return Tree(**fields)


def _binned(d: Arrays, dev) -> BinnedMatrix:
    nbins_total = int(d["nbins_total"])
    return BinnedMatrix(
        bins=torch.zeros((0, len(d["names"])), dtype=torch.int8
                         if nbins_total <= 127 else torch.int32,
                         device=dev),
        nbins=torch.from_numpy(np.array(d["nbins"], np.int32)).to(dev),
        edges=_f32(d["edges"], dev),
        is_cat=np.asarray(d["is_cat"], bool),
        names=list(d["names"]), nbins_total=nbins_total, nrows=0,
        domains=[None if dom is None else list(dom)
                 for dom in d["domains"]],
        nbins_cats=int(d["nbins_cats"]))


def _output(d: Arrays) -> dict:
    domain = None if d["domain"] is None else list(d["domain"])
    return {"category": str(d["category"]), "domain": domain,
            "response": d.get("response"),
            "names": list(d["names"]),
            "nclasses": int(d.get("nclasses") or
                            (len(domain) if domain else 1)),
            "default_threshold": float(d.get("default_threshold", 0.5))}


def _calibrated(model, d: Arrays):
    """Attach ``d["calibrator"]``, the reference calibrator's
    ``(method, params)``, if there is one."""
    cal = d.get("calibrator")
    if cal is not None:
        model.calibrator = Calibrator(str(cal[0]), cal[1])
    return model


def _cross_validated(model, d: Arrays):
    """Set ``_cv_holdout`` (float32) and ``_cv_folds`` from
    ``d["cv_holdout"]`` and ``d["cv_folds"]``, where the reference model
    has them."""
    if d.get("cv_holdout") is not None:
        model._cv_holdout = np.asarray(d["cv_holdout"], np.float32)
        model._cv_folds = np.asarray(d["cv_folds"], np.int32)
    return model


def gbm_model_from_arrays(d: Arrays, device: DeviceLike = None) -> GBMModel:
    """Port ``GBMModel`` on ``device`` from the reference model's images.

    Required keys: the ``Tree`` fields (``left_words`` as the reference's
    uint32 words), ``edges``, ``nbins``, ``is_cat``, ``names``,
    ``domains``, ``nbins_total``, ``nbins_cats``, ``f0``, ``dist_name``,
    ``category``, ``domain``. Optional: ``response``, ``nclasses`` (the
    domain's length), ``default_threshold`` (0.5), ``params`` (the
    training parameters: a family's shape parameter, the offset column,
    what a checkpoint restart checks), ``init_f``, ``calibrator``
    (``(method, params)``), ``cv_holdout`` and ``cv_folds``. A
    multinomial model's ``f0`` is the [K] vector and its forest the
    t-major [T·K] stack (tree t, class k at row t·K + k)."""
    dev = resolve_device(device)
    f0 = np.asarray(d["f0"], np.float32)
    output = _output(d)
    if d.get("init_f") is not None:
        output["init_f"] = float(d["init_f"])
    return _cross_validated(_calibrated(
        GBMModel(dict(d.get("params") or {}), output,
                 keep_layout(_forest(d, dev)), _binned(d, dev),
                 f0 if f0.ndim else np.float32(f0), str(d["dist_name"])),
        d), d)


def drf_model_from_arrays(d: Arrays, device: DeviceLike = None) -> DRFModel:
    """Port ``DRFModel`` (binomial, multinomial or regression) on
    ``device`` from the reference model's images: the keys of
    ``gbm_model_from_arrays`` without ``f0``/``dist_name``/``init_f``
    (a multinomial forest is the t-major [T·K] stack), and optionally
    ``oob_sum`` [Npad, K] and ``oob_cnt`` [Npad], the out-of-bag
    accumulators a checkpoint restart continues."""
    dev = resolve_device(device)
    model = DRFModel(dict(d.get("params") or {}), _output(d),
                     _forest(d, dev), _binned(d, dev))
    if d.get("oob_sum") is not None:
        model._oob = (_f32(d["oob_sum"], dev), _f32(d["oob_cnt"], dev))
    return _cross_validated(_calibrated(model, d), d)


def uplift_model_from_arrays(d: Arrays,
                             device: DeviceLike = None) -> UpliftDRFModel:
    """Port ``UpliftDRFModel`` on ``device`` from the reference model's
    images: the ``Tree`` fields (``leaf`` = p_t - p_c), ``leaf_pt`` and
    ``leaf_pc`` [T, 2^D], the binning keys of ``gbm_model_from_arrays``,
    ``domain`` (the response's), ``treatment_domain``, ``response`` and
    ``params`` (which must name ``treatment_column``; ``auuc_type`` and
    ``auuc_nbins`` are read from it too)."""
    dev = resolve_device(device)
    params = dict(d["params"])
    if not params.get("treatment_column"):
        raise ValueError("uplift_model_from_arrays: params must name the "
                         "treatment_column")
    output = {"category": "BinomialUplift", "response": d["response"],
              "names": list(d["names"]), "domain": list(d["domain"]),
              "treatment_domain": list(d["treatment_domain"]),
              "nclasses": 2}
    return UpliftDRFModel(params, output, _forest(d, dev),
                          _f32(d["leaf_pt"], dev), _f32(d["leaf_pc"], dev),
                          _binned(d, dev))


def isofor_model_from_arrays(
        d: Arrays, device: DeviceLike = None) -> IsolationForestModel:
    """Port ``IsolationForestModel`` on ``device`` from the reference
    model's images: the ``Tree`` fields, the binning keys of
    ``gbm_model_from_arrays``, ``c_norm``, and optionally
    ``min_path_length`` / ``max_path_length`` (the training bounds of
    the score; without them it is 2^(-l / c_norm)) and ``params``."""
    dev = resolve_device(device)
    output = {"category": ANOMALY, "response": None,
              "names": list(d["names"]), "domain": None}
    for k in ("min_path_length", "max_path_length"):
        if d.get(k) is not None:
            output[k] = int(d[k])
    return IsolationForestModel(dict(d.get("params") or {}), output,
                                _forest(d, dev), _binned(d, dev),
                                float(d["c_norm"]))


def extisofor_model_from_arrays(
        d: Arrays, device: DeviceLike = None) -> ExtendedIsolationForestModel:
    """Port ``ExtendedIsolationForestModel`` on ``device`` from the
    reference model's images: ``normals`` [T, D, Lmax, F], ``offsets``
    and ``is_split`` [T, D, Lmax], ``leaf`` [T, 2^D], ``means`` and
    ``features`` (the numeric columns, in order), ``c_norm``, and
    optionally ``params``."""
    dev = resolve_device(device)
    forest = ExtTree(_f32(d["normals"], dev), _f32(d["offsets"], dev),
                     torch.from_numpy(np.array(d["is_split"], bool)).to(
                         dev),
                     _f32(d["leaf"], dev))
    output = {"category": ANOMALY, "response": None,
              "names": list(d["features"]), "domain": None}
    return ExtendedIsolationForestModel(
        dict(d.get("params") or {}), output, forest, float(d["c_norm"]),
        [float(m) for m in d["means"]], list(d["features"]))


def _di_stats(st) -> dict:
    """Design statistics (``num_means``, ``num_sigmas``, ``domains``)."""
    return {"num_means": np.asarray(st["num_means"], np.float64),
            "num_sigmas": np.asarray(st["num_sigmas"], np.float64),
            "domains": [None if dom is None else list(dom)
                        for dom in st["domains"]]}


def glm_model_from_arrays(d: Arrays) -> GLMModel:
    """Port ``GLMModel`` from the reference model's images: ``coef``
    [P+1] (or ``coef_multinomial`` [P+1, K]), ``family`` (name),
    ``link``, ``tweedie_power``, ``theta``, ``di_stats`` (``num_means``,
    ``num_sigmas``, ``domains``), ``features``, ``output`` (the
    reference's output dict: category, response, coef_names, domain,
    coef_means, coef_sds, standardized, default_threshold and, for an
    ordinal model, family and ``ordinal_alphas``) and ``params``. The
    model scores on the device of the frame it is given."""
    stats = _di_stats(d["di_stats"])
    cm = d.get("coef_multinomial")
    return _cross_validated(GLMModel(
        dict(d.get("params") or {}), dict(d["output"]), np.asarray(d["coef"]),
        Family(str(d["family"]), float(d.get("tweedie_power", 1.5)),
               d.get("link"), theta=float(d.get("theta", 1e-5))),
        stats, list(d["features"]),
        coef_multinomial=None if cm is None else np.asarray(cm)), d)


def deeplearning_model_from_arrays(d: Arrays) -> DeepLearningModel:
    """Port ``DeepLearningModel`` from the reference model's images:
    ``net`` (each layer's ``W`` [fan_in, fan_out] and ``b``),
    ``di_stats`` (``num_means``, ``num_sigmas``, ``domains``),
    ``features``, ``act``, ``standardize``, ``resp_stats`` (a regression
    target's mean and sigma, or None), ``output`` (the reference's output
    dict), ``params``, and for a ``checkpoint=`` continuation
    ``opt_state`` (per layer, ``W`` and ``b`` each ``{"eg2", "ex2"}`` or
    ``{"v", "mu"}``) and ``steps_trained``. The net lives on the CPU and
    scores on the device of the frame it is given."""
    st = d["di_stats"]
    stats = {"num_means": np.asarray(st["num_means"], np.float64),
             "num_sigmas": np.asarray(st["num_sigmas"], np.float64),
             "domains": [None if dom is None else list(dom)
                         for dom in st["domains"]]}
    net = [{k: torch.from_numpy(np.array(l[k], np.float32)) for k in ("W", "b")}
           for l in d["net"]]
    rs = d.get("resp_stats")
    model = DeepLearningModel(
        dict(d.get("params") or {}), dict(d["output"]), net, stats,
        list(d["features"]), str(d["act"]), bool(d["standardize"]),
        None if rs is None else (float(rs[0]), float(rs[1])))
    model._opt_state = d.get("opt_state")   # numpy; the restart copies it
    model._steps_trained = int(d.get("steps_trained") or 0)
    return _cross_validated(model, d)


def kmeans_model_from_arrays(d: Arrays) -> KMeansModel:
    """Port ``KMeansModel`` from the reference model's images:
    ``centers_std`` [k, P] (the design's space), ``di_stats``,
    ``features``, ``standardize``, ``output`` and ``params``. The centers
    live on the CPU; the model scores on the device of the frame it is
    given."""
    return KMeansModel(dict(d.get("params") or {}), dict(d["output"]),
                       _f32(d["centers_std"], "cpu"),
                       _di_stats(d["di_stats"]), list(d["features"]),
                       bool(d["standardize"]))


def pca_model_from_arrays(d: Arrays) -> PCAModel:
    """Port ``PCAModel``: ``eigvecs`` [P, k], ``di_stats``,
    ``features``, ``transform``, ``use_all_levels``, ``output`` and
    ``params``."""
    return PCAModel(dict(d.get("params") or {}), dict(d["output"]),
                    _f32(d["eigvecs"], "cpu"), _di_stats(d["di_stats"]),
                    list(d["features"]), str(d["transform"]),
                    bool(d["use_all_levels"]))


def svd_model_from_arrays(d: Arrays) -> SVDModel:
    """Port ``SVDModel``: ``V`` [P, k], ``di_stats``, ``features``,
    ``transform``, ``use_all_levels`` and ``output`` (with ``d``, the
    singular values) and ``params``."""
    return SVDModel(dict(d.get("params") or {}), dict(d["output"]),
                    _f32(d["V"], "cpu"), _di_stats(d["di_stats"]),
                    list(d["features"]), str(d["transform"]),
                    bool(d["use_all_levels"]))


def glrm_model_from_arrays(d: Arrays) -> GLRMModel:
    """Port ``GLRMModel``: the archetypes ``Y`` [k, P], ``di_stats``,
    ``features``, ``transform``, ``output`` and ``params``."""
    return GLRMModel(dict(d.get("params") or {}), dict(d["output"]),
                     _f32(d["Y"], "cpu"), _di_stats(d["di_stats"]),
                     list(d["features"]), str(d["transform"]))


def naivebayes_model_from_arrays(d: Arrays) -> NaiveBayesModel:
    """Port ``NaiveBayesModel``: ``stats`` (``priors``, ``num_names``,
    ``num_mu``, ``num_sd``, ``cat_names``, ``cat_tables``,
    ``cat_domains``), ``output`` and ``params``."""
    st = d["stats"]
    stats = {"priors": np.asarray(st["priors"], np.float32),
             "num_names": list(st["num_names"]),
             "num_mu": [np.asarray(a, np.float32) for a in st["num_mu"]],
             "num_sd": [np.asarray(a, np.float32) for a in st["num_sd"]],
             "cat_names": list(st["cat_names"]),
             "cat_tables": [np.asarray(a, np.float32)
                            for a in st["cat_tables"]],
             "cat_domains": [list(dom) for dom in st["cat_domains"]]}
    return NaiveBayesModel(dict(d.get("params") or {}), dict(d["output"]),
                           stats)


def targetencoder_model_from_arrays(d: Arrays) -> TargetEncoderModel:
    """Port ``TargetEncoderModel``: ``enc_maps`` (a column's ``sum`` and
    ``cnt`` [nfolds, card], ``domain`` and ``prior``), ``output`` and
    ``params``."""
    maps = {col: {"sum": np.asarray(m["sum"], np.float64),
                  "cnt": np.asarray(m["cnt"], np.float64),
                  "domain": list(m["domain"]), "prior": float(m["prior"])}
            for col, m in d["enc_maps"].items()}
    return TargetEncoderModel(dict(d.get("params") or {}),
                              dict(d["output"]), maps)


def gam_model_from_arrays(d: Arrays) -> GAMModel:
    """Port ``GAMModel``: ``coef`` [P+1], ``family``, ``link``,
    ``tweedie_power``, ``di_stats``, ``features``, ``gam_spec`` (per gam
    column ``col``, ``knots``, ``means`` and ``scale``), ``output`` and
    ``params``. The model scores on the device of the frame it is
    given."""
    spec = [{"col": str(s["col"]),
             "knots": np.asarray(s["knots"], np.float64),
             "means": np.asarray(s["means"], np.float64),
             "scale": float(s.get("scale", 1.0))} for s in d["gam_spec"]]
    return GAMModel(dict(d.get("params") or {}), dict(d["output"]),
                    np.asarray(d["coef"], np.float32),
                    Family(str(d["family"]),
                           float(d.get("tweedie_power", 1.5)),
                           d.get("link")),
                    _di_stats(d["di_stats"]), list(d["features"]), spec)


def rulefit_model_from_arrays(d: Arrays,
                              device: DeviceLike = None) -> RuleFitModel:
    """Port ``RuleFitModel``: ``tree_models`` (each the arrays of
    ``gbm_model_from_arrays``, or of ``drf_model_from_arrays`` with
    ``algo`` "drf"), ``glm`` (the arrays of ``glm_model_from_arrays``),
    ``rules`` (each ``model``, ``tree``, ``lo``, ``hi``, ``name``, and
    ``lang`` and ``support``), ``linear_cols``, ``winsor`` (name → (lo,
    hi)), ``output`` and ``params``. The forests live on ``device``."""
    tree_models = [drf_model_from_arrays(t, device) if t.get("algo") == "drf"
                   else gbm_model_from_arrays(t, device)
                   for t in d["tree_models"]]
    rules = [{k: r[k] for k in ("model", "tree", "lo", "hi", "name", "lang",
                                "support") if k in r} for r in d["rules"]]
    return RuleFitModel(dict(d.get("params") or {}), dict(d["output"]),
                        glm_model_from_arrays(d["glm"]), tree_models, rules,
                        list(d["linear_cols"]),
                        {k: (float(v[0]), float(v[1]))
                         for k, v in d["winsor"].items()})


def anovaglm_model_from_arrays(d: Arrays) -> ANOVAGLMModel:
    """Port ``ANOVAGLMModel``: ``full`` (the full GLM's arrays, as
    ``glm_model_from_arrays`` takes them), ``output`` (with the
    ``anova_table``) and ``params``."""
    return ANOVAGLMModel(dict(d.get("params") or {}), dict(d["output"]),
                         glm_model_from_arrays(d["full"]))


def modelselection_model_from_arrays(d: Arrays) -> ModelSelectionModel:
    """Port ``ModelSelectionModel``: ``best_models`` (predictor count →
    that GLM's arrays), ``output`` (with ``best_per_size``) and
    ``params``."""
    return ModelSelectionModel(
        dict(d.get("params") or {}), dict(d["output"]),
        {int(k): glm_model_from_arrays(g)
         for k, g in d["best_models"].items()})


def isotonic_model_from_arrays(d: Arrays) -> IsotonicRegressionModel:
    """Port ``IsotonicRegressionModel``: ``thresholds_x`` (float32, as
    the reference keeps them), ``thresholds_y``, ``output`` and
    ``params``."""
    return IsotonicRegressionModel(
        dict(d.get("params") or {}), dict(d["output"]),
        np.asarray(d["thresholds_x"], np.float32),
        np.asarray(d["thresholds_y"], np.float64))


def coxph_model_from_arrays(d: Arrays) -> CoxPHModel:
    """Port ``CoxPHModel``: ``coef`` [P] (the design's coefficients),
    ``di_stats``, ``features``, ``output`` (the reference's, with
    ``eta_mean`` and ``response``) and ``params`` (``stop_column``)."""
    return CoxPHModel(dict(d.get("params") or {}), dict(d["output"]),
                      np.asarray(d["coef"], np.float64),
                      _di_stats(d["di_stats"]), list(d["features"]))


def psvm_model_from_arrays(d: Arrays) -> PSVMModel:
    """Port ``PSVMModel``: ``w_b`` [r+1], ``pivot_rows`` [r, P] (the
    standardized design's rows), ``Linv_t`` [r, r], ``gamma``,
    ``di_stats``, ``features``, ``output`` and ``params``."""
    return PSVMModel(dict(d.get("params") or {}), dict(d["output"]),
                     np.asarray(d["w_b"], np.float32),
                     np.asarray(d["pivot_rows"], np.float32),
                     np.asarray(d["Linv_t"], np.float32), float(d["gamma"]),
                     _di_stats(d["di_stats"]), list(d["features"]))


def word2vec_model_from_arrays(d: Arrays) -> Word2VecModel:
    """Port ``Word2VecModel``: ``vectors`` [V, D], ``vocab``, ``output``
    and ``params``."""
    return Word2VecModel(dict(d.get("params") or {}), dict(d["output"]),
                         np.asarray(d["vectors"], np.float32),
                         [str(w) for w in d["vocab"]])
