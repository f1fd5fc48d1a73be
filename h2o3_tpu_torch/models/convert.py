"""Carry a trained GBM across from the reference package's numpy images.

``gbm_model_from_arrays`` builds a port ``GBMModel`` from plain numpy
arrays and lists — every ``Tree`` field of the stacked forest, the
training binning (``edges``, ``nbins``, ``is_cat``, ``names``,
``domains``, ``nbins_total``, ``nbins_cats``), ``f0``, ``dist_name`` and
the output ``category`` and ``domain`` — so both packages score the same
forest. Nothing here imports the reference package: the caller hands
over numpy.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import BinnedMatrix
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.tree import Tree
from h2o3_tpu_torch.parallel.device import DeviceLike, resolve_device

_TREE_DTYPES = {"feat": torch.int32, "thresh": torch.int32,
                "na_left": torch.bool, "is_split": torch.bool,
                "leaf": torch.float32, "leaf_w": torch.float32,
                "cat_split": torch.bool, "left_words": torch.int32}


def gbm_model_from_arrays(d: Dict[str, Union[np.ndarray, List]],
                          device: DeviceLike = None) -> GBMModel:
    """Port ``GBMModel`` on ``device`` from the reference model's images.

    Required keys: the ``Tree`` fields (``left_words`` as the reference's
    uint32 words), ``edges``, ``nbins``, ``is_cat``, ``names``,
    ``domains``, ``nbins_total``, ``nbins_cats``, ``f0``, ``dist_name``,
    ``category``, ``domain``. Optional: ``response``,
    ``default_threshold`` (0.5), ``params``."""
    dev = resolve_device(device)
    fields = {}
    for f in Tree._fields:
        a = np.ascontiguousarray(np.asarray(d[f]))
        if f == "left_words":
            a = a.astype(np.uint32).view(np.int32)   # same bit pattern
        fields[f] = torch.from_numpy(a.copy()).to(dev, _TREE_DTYPES[f])
    forest = Tree(**fields)
    nbins_total = int(d["nbins_total"])
    bm = BinnedMatrix(
        bins=torch.zeros((0, len(d["names"])), dtype=torch.int8
                         if nbins_total <= 127 else torch.int32,
                         device=dev),
        nbins=torch.from_numpy(np.array(d["nbins"], np.int32)).to(dev),
        edges=torch.from_numpy(np.array(d["edges"], np.float32)).to(dev),
        is_cat=np.asarray(d["is_cat"], bool),
        names=list(d["names"]), nbins_total=nbins_total, nrows=0,
        domains=[None if dom is None else list(dom)
                 for dom in d["domains"]],
        nbins_cats=int(d["nbins_cats"]))
    output = {"category": str(d["category"]),
              "domain": None if d["domain"] is None else list(d["domain"]),
              "response": d.get("response"),
              "names": list(d["names"]),
              "default_threshold": float(d.get("default_threshold", 0.5))}
    return GBMModel(dict(d.get("params") or {}), output, forest, bm,
                    np.float32(d["f0"]), str(d["dist_name"]))
