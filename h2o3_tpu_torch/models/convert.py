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
across: its coefficients, family and design statistics. Nothing here
imports the reference package: the caller hands over numpy.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import BinnedMatrix
from h2o3_tpu_torch.ml.calibration import Calibrator
from h2o3_tpu_torch.models.drf import DRFModel
from h2o3_tpu_torch.models.extisofor import (ExtendedIsolationForestModel,
                                             ExtTree)
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.glm import Family, GLMModel
from h2o3_tpu_torch.models.isofor import ANOMALY, IsolationForestModel
from h2o3_tpu_torch.models.tree import Tree
from h2o3_tpu_torch.models.uplift import UpliftDRFModel
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


def gbm_model_from_arrays(d: Arrays, device: DeviceLike = None) -> GBMModel:
    """Port ``GBMModel`` on ``device`` from the reference model's images.

    Required keys: the ``Tree`` fields (``left_words`` as the reference's
    uint32 words), ``edges``, ``nbins``, ``is_cat``, ``names``,
    ``domains``, ``nbins_total``, ``nbins_cats``, ``f0``, ``dist_name``,
    ``category``, ``domain``. Optional: ``response``, ``nclasses`` (the
    domain's length), ``default_threshold`` (0.5), ``params`` (the
    training parameters: a family's shape parameter, the offset column,
    what a checkpoint restart checks), ``init_f``, ``calibrator``
    (``(method, params)``). A multinomial model's ``f0`` is the [K]
    vector and its forest the t-major [T·K] stack (tree t, class k at
    row t·K + k)."""
    dev = resolve_device(device)
    f0 = np.asarray(d["f0"], np.float32)
    output = _output(d)
    if d.get("init_f") is not None:
        output["init_f"] = float(d["init_f"])
    return _calibrated(
        GBMModel(dict(d.get("params") or {}), output, _forest(d, dev),
                 _binned(d, dev), f0 if f0.ndim else np.float32(f0),
                 str(d["dist_name"])), d)


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
    return _calibrated(model, d)


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


def glm_model_from_arrays(d: Arrays) -> GLMModel:
    """Port ``GLMModel`` from the reference model's images: ``coef``
    [P+1] (or ``coef_multinomial`` [P+1, K]), ``family`` (name),
    ``link``, ``tweedie_power``, ``theta``, ``di_stats`` (``num_means``,
    ``num_sigmas``, ``domains``), ``features``, ``output`` (the
    reference's output dict: category, response, coef_names, domain,
    coef_means, coef_sds, standardized, default_threshold and, for an
    ordinal model, family and ``ordinal_alphas``) and ``params``. The
    model scores on the device of the frame it is given."""
    st = d["di_stats"]
    stats = {"num_means": np.asarray(st["num_means"], np.float64),
             "num_sigmas": np.asarray(st["num_sigmas"], np.float64),
             "domains": [None if dom is None else list(dom)
                         for dom in st["domains"]]}
    cm = d.get("coef_multinomial")
    return GLMModel(dict(d.get("params") or {}), dict(d["output"]),
                    np.asarray(d["coef"]),
                    Family(str(d["family"]), float(d.get("tweedie_power",
                                                         1.5)),
                           d.get("link"), theta=float(d.get("theta", 1e-5))),
                    stats, list(d["features"]),
                    coef_multinomial=None if cm is None else np.asarray(cm))
