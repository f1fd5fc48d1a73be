"""MOJO export — a trained port model to the offline format.

Reference: h2o3_tpu/genmodel/export.py (the per-algo *MojoWriter
classes, invoked from Model.getMojo; here one dispatch over the live
model). The port's models hold torch tensors, on the card or the CPU:
``host_model`` gives a read-only view of a model whose tensors read as
host numpy arrays in the reference's dtypes (a forest's ``left_words``
as uint32 words, a ``HeapTree`` forest in the dense ``[T, D, Lmax]``
layout), so ``mojo_artifacts`` and the reference-format writers
(``refmojo.py``) read a port model as the reference's read its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _dense_forest(heap, B: int):
    """A HeapTree forest [T, 2^D - 1] in the dense Tree layout [T, D,
    Lmax] on the host, with the padding the growers leave (feat 0,
    thresh B, the flags False, no left words)."""
    from h2o3_tpu_torch.models.tree import Tree, tree_depth
    D = tree_depth(heap)
    T = heap.feat.shape[0]
    Lmax = 2 ** (D - 1) if D > 0 else 1
    W = heap.left_words.shape[-1]
    out = {"feat": np.zeros((T, D, Lmax), np.int32),
           "thresh": np.full((T, D, Lmax), B, np.int32),
           "na_left": np.zeros((T, D, Lmax), bool),
           "is_split": np.zeros((T, D, Lmax), bool),
           "cat_split": np.zeros((T, D, Lmax), bool),
           "left_words": np.zeros((T, D, Lmax, W), np.uint32)}
    for t in range(T):        # one tree at a time on the host
        flat = {f: getattr(heap, f)[t].cpu().numpy() for f in out}
        flat["left_words"] = flat["left_words"].view(np.uint32)
        for d in range(D):
            s = slice(2 ** d - 1, 2 ** (d + 1) - 1)
            for f, a in out.items():
                a[t, d, :2 ** d] = flat[f][s]
    return Tree(out["feat"], out["thresh"], out["na_left"], out["is_split"],
                heap.leaf.cpu().numpy(), heap.leaf_w.cpu().numpy(),
                out["cat_split"], out["left_words"])


def host_value(v, nbins_total: int = 0):
    """``v`` with its tensors lowered to host numpy (recursively through
    lists, tuples and dicts; a Tree or HeapTree forest as a host Tree)."""
    from h2o3_tpu_torch.models.tree import HeapTree, Tree
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, HeapTree):
        return _dense_forest(v, nbins_total)
    if isinstance(v, Tree):
        host = Tree(*(a.detach().cpu().numpy() for a in v))
        return host._replace(left_words=host.left_words.view(np.uint32))
    if isinstance(v, list):
        return [host_value(x) for x in v]
    if isinstance(v, tuple):
        vals = (host_value(x) for x in v)
        return type(v)(*vals) if hasattr(v, "_fields") else tuple(vals)
    if isinstance(v, dict):
        return {k: host_value(x) for k, x in v.items()}
    if hasattr(v, "__dataclass_fields__") or (hasattr(v, "key")
                                               and hasattr(v, "algo")):
        return HostModel(v)     # a BinnedMatrix, a nested model
    return v


class HostModel:
    """A model (or a binning) whose attributes read on the host."""

    def __init__(self, obj):
        object.__setattr__(self, "_obj", obj)

    def __getattr__(self, name):
        obj = object.__getattribute__(self, "_obj")
        bm = getattr(obj, "bm", None) if name == "forest" else None
        return host_value(getattr(obj, name),
                          0 if bm is None else int(bm.nbins_total))


def host_model(model) -> HostModel:
    return HostModel(model)


def _tree_artifacts(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Shared forest + binning serialization for the tree models."""
    bm = model.bm
    f = model.forest
    arrays = {
        "tree_feat": np.asarray(f.feat),
        "tree_thresh": np.asarray(f.thresh),
        "tree_na_left": np.asarray(f.na_left),
        "tree_is_split": np.asarray(f.is_split),
        "tree_leaf": np.asarray(f.leaf),
        "tree_leaf_w": np.asarray(f.leaf_w),
        "tree_cat_split": np.asarray(f.cat_split),
        "tree_left_words": np.asarray(f.left_words),
        "edges": np.asarray(bm.edges),
        "nbins": np.asarray(bm.nbins),
        "is_cat": np.asarray(bm.is_cat),
    }
    meta = {
        "nbins_total": int(bm.nbins_total),
        "feature_domains": [list(d) if d is not None else None
                            for d in bm.domains],
    }
    return meta, arrays


def _base_meta(model) -> dict:
    out = model.output
    return {
        "algo": model.algo,
        "category": out.get("category"),
        "names": list(out.get("names") or []),
        "response": out.get("response"),
        "domain": out.get("domain"),
        "nclasses": out.get("nclasses", 1),
        "default_threshold": out.get("default_threshold", 0.5),
    }


def _design_meta(model, meta: dict, arrays: dict) -> None:
    meta["names"] = list(model.features)
    meta["feature_domains"] = [list(d) if d is not None else None
                               for d in model.di_stats["domains"]]
    arrays["num_means"] = np.asarray(model.di_stats["num_means"])
    arrays["num_sigmas"] = np.asarray(model.di_stats["num_sigmas"])


def mojo_artifacts(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(meta, arrays) of the MOJO of a port model: the reference's keys,
    values and array dtypes for each of its 16 exportable algorithms."""
    return _artifacts(host_model(model))


def _artifacts(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    algo = model.algo
    meta = _base_meta(model)
    arrays: Dict[str, np.ndarray] = {}
    if algo in ("gbm", "drf", "isolationforest"):
        tmeta, arrays = _tree_artifacts(model)
        meta.update(tmeta)
        if algo == "gbm":
            meta["f0"] = (np.asarray(model.f0).tolist())
            meta["distribution"] = model.dist_name
            meta["tweedie_power"] = float(model.params.get("tweedie_power",
                                                           1.5))
        elif algo == "isolationforest":
            meta["c_norm"] = float(model.c_norm)
            # the training path-length extrema the scorer normalizes with
            for stat in ("min_path_length", "max_path_length"):
                if model.output.get(stat) is not None:
                    meta[stat] = int(model.output[stat])
        return meta, arrays
    if algo == "glm":
        meta["link"] = model.family.link
        meta["family"] = model.family.name
        meta["tweedie_power"] = float(getattr(model.family, "p", 1.5))
        meta["standardize"] = bool(model.params.get("standardize", True))
        meta["use_all_factor_levels"] = bool(
            model.params.get("use_all_factor_levels", False))
        _design_meta(model, meta, arrays)
        if model.coef_multinomial is not None:
            arrays["coef_multinomial"] = np.asarray(model.coef_multinomial)
        else:
            arrays["coef"] = np.asarray(model.coef)
        return meta, arrays
    if algo == "deeplearning":
        meta["activation"] = model.act
        meta["standardize"] = bool(model.standardize)
        meta["use_all_factor_levels"] = bool(
            model.params.get("use_all_factor_levels", False))
        meta["autoencoder"] = bool(model.params.get("autoencoder", False))
        meta["n_layers"] = len(model.net)
        _design_meta(model, meta, arrays)
        if model.resp_stats is not None:
            meta["resp_stats"] = [float(model.resp_stats[0]),
                                  float(model.resp_stats[1])]
        for i, layer in enumerate(model.net):
            arrays[f"W{i}"] = np.asarray(layer["W"])
            arrays[f"b{i}"] = np.asarray(layer["b"])
        return meta, arrays
    if algo in ("pca", "svd"):
        meta["standardize"] = model.transform == "standardize"
        meta["use_all_factor_levels"] = bool(model.use_all_levels)
        _design_meta(model, meta, arrays)
        if algo == "pca":
            arrays["eigvecs"] = np.asarray(model.eigvecs)
        else:
            arrays["v"] = np.asarray(model.V)
            arrays["d"] = np.asarray(model.output["d"])
        return meta, arrays
    if algo == "isotonicregression":
        meta["out_of_bounds"] = str(model.params.get("out_of_bounds",
                                                     "clip"))
        arrays = {"thresholds_x": np.asarray(model.tx),
                  "thresholds_y": np.asarray(model.ty)}
        return meta, arrays
    if algo == "coxph":
        meta["names"] = list(model.features)
        meta["feature_domains"] = [list(d) if d is not None else None
                                   for d in model.di_stats["domains"]]
        meta["standardize"] = False
        meta["use_all_factor_levels"] = False
        meta["eta_mean"] = float(model.output["eta_mean"])
        arrays = {
            "coef": np.asarray(model.coef),
            "num_means": np.asarray(model.di_stats["num_means"]),
            "num_sigmas": np.asarray(model.di_stats["num_sigmas"]),
        }
        return meta, arrays
    if algo == "naivebayes":
        s = model.stats
        meta["num_names"] = list(s["num_names"])
        meta["cat_names"] = list(s["cat_names"])
        meta["cat_domains"] = [list(d) for d in s["cat_domains"]]
        meta["min_sdev"] = float(model.params.get("min_sdev") or 1e-3)
        meta["eps_sdev"] = float(model.params.get("eps_sdev") or 0.0)
        meta["min_prob"] = float(model.params.get("min_prob") or 1e-3)
        arrays = {"priors": np.asarray(s["priors"]),
                  "num_mu": np.asarray(s["num_mu"]),
                  "num_sd": np.asarray(s["num_sd"])}
        for j, tab in enumerate(s["cat_tables"]):
            arrays[f"cat_table_{j}"] = np.asarray(tab)
        return meta, arrays
    if algo == "upliftdrf":
        tmeta, arrays = _tree_artifacts(model)
        meta.update(tmeta)
        arrays["leaf_pt"] = np.asarray(model.leaf_pt)
        arrays["leaf_pc"] = np.asarray(model.leaf_pc)
        return meta, arrays
    if algo == "extendedisolationforest":
        meta["names"] = list(model.features)
        meta["c_norm"] = float(model.c_norm)
        f = model.forest
        arrays = {"ext_normals": np.asarray(f.normals),
                  "ext_offsets": np.asarray(f.offsets),
                  "ext_is_split": np.asarray(f.is_split),
                  "ext_leaf": np.asarray(f.leaf),
                  "col_means": np.asarray(model.means)}
        return meta, arrays
    if algo == "glrm":
        meta["standardize"] = model.transform == "standardize"
        meta["use_all_factor_levels"] = True
        _design_meta(model, meta, arrays)
        arrays = {"archetypes": np.asarray(model.Y), **arrays}
        return meta, arrays
    if algo == "word2vec":
        meta["vocab"] = list(model.vocab)
        arrays = {"vectors": np.asarray(model.vectors)}
        return meta, arrays
    if algo == "kmeans":
        meta["standardize"] = bool(model.standardize)
        meta["use_all_factor_levels"] = True
        _design_meta(model, meta, arrays)
        arrays = {"centers": np.asarray(model.centers_std), **arrays}
        return meta, arrays
    if algo == "rulefit":
        # composite MOJO: the rule forests and the GLM head (the
        # reference's RuleFitMojoWriter bundles both parts)
        glm_meta, glm_arrays = _artifacts(model.glm_model)
        meta["glm"] = glm_meta
        meta["rules"] = [{"model": r["model"], "tree": int(r["tree"]),
                          "lo": int(r["lo"]), "hi": int(r["hi"]),
                          "name": r["name"]} for r in model.rules]
        meta["linear_cols"] = list(model.linear_cols)
        meta["winsor"] = {n: [float(lo), float(hi)]
                          for n, (lo, hi) in model.winsor.items()}
        meta["n_tree_models"] = len(model.tree_models)
        arrays = {f"glm_{k}": v for k, v in glm_arrays.items()}
        for i, tm in enumerate(model.tree_models):
            tmeta, tarrays = _tree_artifacts(tm)
            meta[f"tm{i}_nbins_total"] = tmeta["nbins_total"]
            meta[f"tm{i}_feature_domains"] = tmeta["feature_domains"]
            meta[f"tm{i}_names"] = list(tm.bm.names)
            arrays.update({f"tm{i}_{k}": v for k, v in tarrays.items()})
        return meta, arrays
    raise ValueError(f"MOJO export not supported for algo '{algo}'")
