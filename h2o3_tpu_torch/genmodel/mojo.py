"""MOJO — the portable trained-model artifact format.

The port's copy of h2o3_tpu/genmodel/mojo.py; the port imports nothing
of the reference package, so it keeps its own.

Reference: h2o-genmodel MOJO zips (hex/genmodel/MojoModel.java:12,
readers under hex/genmodel/algos/{gbm,drf,glm,deeplearning,kmeans,
isofor}) — a zip of a `model.ini` plus binary blobs, scored offline by a
dependency-free runtime (GenModel.score0, hex/genmodel/GenModel.java:363).

TPU-native redesign: the artifact is a zip of
  - ``meta.json``  — algo, category, feature names/types, response
    domain, per-feature categorical domains, scalar scoring constants
  - ``arrays.npz`` — every numeric blob (tree tensors, bin edges,
    coefficients, layer weights, centroids) as plain numpy arrays
and the offline runtime (readers.py) is numpy-only — no JAX, no device —
so exported models score anywhere a `pip install numpy` exists, the same
portability contract the reference's genmodel jar provides.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict

import numpy as np

MOJO_FORMAT_VERSION = "1.0"


def mojo_bytes(meta: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    """Render a MOJO zip (meta.json + arrays.npz) in memory."""
    meta = dict(meta)
    meta["mojo_version"] = MOJO_FORMAT_VERSION
    npz = io.BytesIO()
    np.savez_compressed(npz, **{k: np.asarray(v) for k, v in arrays.items()})
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("arrays.npz", npz.getvalue())
    return buf.getvalue()


def write_mojo(path: str, meta: dict, arrays: Dict[str, np.ndarray]) -> str:
    """Write a MOJO zip: meta.json + arrays.npz."""
    with open(path, "wb") as fh:
        fh.write(mojo_bytes(meta, arrays))
    return path


def read_mojo(path: str):
    """Read a MOJO zip → (meta dict, arrays dict)."""
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json").decode())
        npz = np.load(io.BytesIO(z.read("arrays.npz")), allow_pickle=False)
        arrays = {k: npz[k] for k in npz.files}
    return meta, arrays


# ------------------------------------------------------------------
# shared raw-row → binned/encoded feature plumbing for the readers
# ------------------------------------------------------------------

def encode_columns(meta: dict, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize a dict of raw columns to float/object numpy arrays."""
    out = {}
    n = None
    for name in meta["names"]:
        if name not in data:
            raise KeyError(f"missing feature column '{name}'")
        v = np.asarray(data[name])
        if n is None:
            n = len(v)
        out[name] = v
    return out


def bin_raw(meta: dict, arrays: Dict[str, np.ndarray],
            data: Dict[str, np.ndarray]) -> np.ndarray:
    """Bin raw feature columns exactly like frame/binning.py bin_frame.

    Numeric: bin = #(edges <= x); categorical: domain index, with
    ADJACENT codes grouped by integer divide when the training
    cardinality exceeded nbins_cats (the DHistogram grouped cat-bin
    cap); NA / unseen level → bin B-1.
    """
    names = meta["names"]
    B = int(meta["nbins_total"])
    nb = arrays["nbins"].astype(np.int64)
    edges = arrays["edges"]
    is_cat = arrays["is_cat"].astype(bool)
    domains = meta.get("feature_domains") or [None] * len(names)
    cols = encode_columns(meta, data)
    n = len(next(iter(cols.values())))
    bins = np.zeros((n, len(names)), dtype=np.int32)
    for i, name in enumerate(names):
        v = cols[name]
        if is_cat[i]:
            dom = domains[i] or []
            lut = {lvl: j for j, lvl in enumerate(dom)}
            if v.dtype.kind in "fiu":       # already numeric codes? treat as str
                v = v.astype(object).astype(str)
            code = np.array([lut.get(str(x), -1) if x is not None else -1
                             for x in v], dtype=np.int64)
            card = max(len(dom), 1)
            div = -(-card // max(nb[i], 1)) if card > nb[i] else 1
            b = code // div if div > 1 else code
            b = np.where(code < 0, B - 1, b)
        else:
            x = v.astype(np.float64)
            e = edges[i]
            e = e[np.isfinite(e)]
            b = np.sum(x[:, None] >= e[None, :], axis=1).astype(np.int64)
            b = np.where(np.isnan(x), B - 1, b)
        bins[:, i] = b
    return bins


def walk_forest(arrays: Dict[str, np.ndarray], bins: np.ndarray,
                B: int) -> np.ndarray:
    """Route binned rows through every stored tree → [T, N] leaf values.

    The numpy twin of models/tree.py predict_tree (the CompressedTree
    walk, hex/genmodel/algos/tree/SharedTreeMojoModel scoring role).
    """
    feat = arrays["tree_feat"]        # [T, D, L]
    thresh = arrays["tree_thresh"]
    na_left = arrays["tree_na_left"].astype(bool)
    is_split = arrays["tree_is_split"].astype(bool)
    leaf = arrays["tree_leaf"]        # [T, 2^D]
    cat_split = arrays.get("tree_cat_split")
    left_words = arrays.get("tree_left_words")
    T = feat.shape[0]
    out = np.zeros((T, bins.shape[0]), dtype=np.float64)
    for t in range(T):
        nid = route_tree_nids(feat[t], thresh[t], na_left[t], is_split[t],
                              bins, B,
                              None if cat_split is None else cat_split[t],
                              None if left_words is None else left_words[t])
        out[t] = leaf[t][nid]
    return out


def route_tree_nids(feat, thresh, na_left, is_split, bins: np.ndarray,
                    B: int, cat_split=None, left_words=None) -> np.ndarray:
    """Terminal leaf id per row for ONE tree [D, L] (RuleFit rule
    membership is a leaf-id range check — models/rulefit.py _route_nids
    twin on the host). Categorical subset splits test the row's bin bit
    in the node's packed left-set words."""
    D = feat.shape[0]
    n = bins.shape[0]
    nid = np.zeros(n, dtype=np.int64)
    for d in range(D):
        f_r = feat[d][nid]
        t_r = thresh[d][nid]
        nal = na_left[d][nid]
        isp = is_split[d][nid]
        b_r = bins[np.arange(n), f_r]
        isna = b_r == (B - 1)
        go = b_r <= t_r
        if cat_split is not None and cat_split[d].any():
            lw = left_words[d][nid]                     # [n, W]
            W = lw.shape[1]
            widx = np.clip(b_r >> 5, 0, W - 1)
            word = lw[np.arange(n), widx]
            inset = ((word >> (b_r & 31).astype(np.uint32)) & 1) == 1
            go = np.where(cat_split[d][nid], inset, go)
        goleft = np.where(isp, np.where(isna, nal, go), True)
        nid = 2 * nid + np.where(goleft, 0, 1)
    return nid


def walk_forest_pathlen(arrays: Dict[str, np.ndarray], bins: np.ndarray,
                        B: int) -> np.ndarray:
    """IsolationForest walk: path length = #splits traversed + the stored
    leaf correction term (models/isofor.py _tree_path_length twin)."""
    feat = arrays["tree_feat"]
    thresh = arrays["tree_thresh"]
    na_left = arrays["tree_na_left"].astype(bool)
    is_split = arrays["tree_is_split"].astype(bool)
    leaf = arrays["tree_leaf"]
    T, D, _ = feat.shape
    n = bins.shape[0]
    out = np.zeros((T, n), dtype=np.float64)
    for t in range(T):
        nid = np.zeros(n, dtype=np.int64)
        plen = np.zeros(n, dtype=np.float64)
        for d in range(D):
            isp = is_split[t, d][nid]
            plen += isp
            f_r = feat[t, d][nid]
            t_r = thresh[t, d][nid]
            nal = na_left[t, d][nid]
            b_r = bins[np.arange(n), f_r]
            isna = b_r == (B - 1)
            goleft = np.where(isp, np.where(isna, nal, b_r <= t_r), True)
            nid = 2 * nid + np.where(goleft, 0, 1)
        out[t] = plen + leaf[t][nid]
    return out


def design_matrix(meta: dict, arrays: Dict[str, np.ndarray],
                  data: Dict[str, np.ndarray]) -> np.ndarray:
    """Numpy twin of frame/datainfo.py build_datainfo: one-hot expansion
    + mean imputation + optional standardization with TRAINING stats."""
    names = meta["names"]
    domains = meta.get("feature_domains") or [None] * len(names)
    standardize = bool(meta.get("standardize", True))
    use_all = bool(meta.get("use_all_factor_levels", False))
    means = arrays["num_means"]
    sigmas = arrays["num_sigmas"]
    cols = encode_columns(meta, data)
    n = len(next(iter(cols.values())))
    blocks = []
    ni = 0
    for i, name in enumerate(names):
        v = cols[name]
        dom = domains[i]
        if dom is not None:
            lut = {lvl: j for j, lvl in enumerate(dom)}
            if v.dtype.kind in "fiu":
                v = v.astype(object).astype(str)
            code = np.array([lut.get(str(x), -1) if x is not None else -1
                             for x in v], dtype=np.int64)
            first = 0 if use_all else 1
            card = max(len(dom), 1)
            oh = (code[:, None] ==
                  np.arange(first, card)[None, :]).astype(np.float64)
            oh[code < 0] = 0.0
            blocks.append(oh)
        else:
            x = v.astype(np.float64)
            mu = float(means[ni]) if ni < len(means) else 0.0
            sd = float(sigmas[ni]) if ni < len(sigmas) else 1.0
            ni += 1
            x = np.where(np.isnan(x), mu, x)
            if standardize:
                x = (x - mu) / (sd if sd > 0 else 1.0)
            blocks.append(x[:, None])
    return (np.concatenate(blocks, axis=1) if blocks
            else np.zeros((n, 0), dtype=np.float64))
