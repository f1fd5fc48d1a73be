"""POJO export — generate a standalone SOURCE-code scorer for a model.

The port's copy of h2o3_tpu/genmodel/pojo.py; the port imports nothing
of the reference package, so it keeps its own.

Reference: hex/Model.java POJO codegen (toJava; hex/genmodel/GenModel as
the base class of generated Java classes) — the exported artifact is
readable source with the model constants embedded, scoring single rows
with zero framework dependencies. The TPU-land analogue generates a
pure-stdlib Python module (no numpy, no jax): `score0(row: dict) -> dict`
with the same outputs as in-cluster predict, plus `predict(rows)` for
lists of rows. MOJO remains the binary artifact; POJO is the readable
one — the same split the reference ships.

Covered algos: gbm, drf (forest walk + binning) and glm (design matrix
+ link), the reference's most-used POJO targets.
"""

from __future__ import annotations

import json

import numpy as np


_TREE_TEMPLATE = '''"""Generated by h2o3-tpu — standalone {algo} scorer.

Usage:  from {modname} import score0
        score0({{"feature": value, ...}}) -> {{"predict": ..., ...}}
No dependencies beyond the Python stdlib.
"""

import json as _json
import math as _math

_M = _json.loads({meta_json_literal})

NAMES = _M["names"]
DOMAIN = _M["domain"]


def _bin_row(row):
    """Raw row -> per-feature bin codes (frame/binning.py semantics:
    numeric bin = #(edges <= x); categorical = domain index mod cap;
    NA / unseen level -> B-1)."""
    B = _M["nbins_total"]
    bins = []
    for i, name in enumerate(NAMES):
        v = row.get(name)
        if _M["is_cat"][i]:
            dom = _M["feature_domains"][i] or []
            try:
                code = dom.index(str(v)) if v is not None else -1
            except ValueError:
                code = -1
            nb = _M["nbins"][i]
            card = max(len(dom), 1)
            if code < 0:
                b = B - 1
            elif nb < card:
                b = code // (-(-card // max(nb, 1)))
            else:
                b = code
        else:
            try:
                x = float(v)
            except (TypeError, ValueError):
                x = float("nan")
            if x != x:
                b = B - 1
            else:
                b = 0
                for e in _M["edges"][i]:
                    if x >= e:
                        b += 1
                    else:
                        break
        bins.append(b)
    return bins


def _walk_tree(t, bins):
    B = _M["nbins_total"]
    feat, thresh, nal, isp = (_M["tree_feat"][t], _M["tree_thresh"][t],
                              _M["tree_na_left"][t], _M["tree_is_split"][t])
    cats = _M.get("tree_cat_split")
    words = _M.get("tree_left_words")
    D = len(feat)
    nid = 0
    for d in range(D):
        if isp[d][nid]:
            b = bins[feat[d][nid]]
            if b == B - 1:
                goleft = nal[d][nid]
            elif cats is not None and cats[t][d][nid]:
                goleft = bool((words[t][d][nid][b >> 5] >> (b & 31)) & 1)
            else:
                goleft = b <= thresh[d][nid]
        else:
            goleft = True
        nid = 2 * nid + (0 if goleft else 1)
    return _M["tree_leaf"][t][nid]


def _margins(bins):
    T = len(_M["tree_feat"])
    K = _M["nclasses"] if _M["category"] == "Multinomial" else 1
    out = [0.0] * K
    for t in range(T):
        out[t % K] += _walk_tree(t, bins)
    return out


def score0(row):
    bins = _bin_row(row)
    cat = _M["category"]
    algo = _M["algo"]
    if algo == "drf":
        T = len(_M["tree_feat"])
        if cat == "Regression":
            return {{"predict": _margins(bins)[0] / T}}
        if cat == "Binomial":
            p1 = min(max(_margins(bins)[0] / T, 0.0), 1.0)
            lab = 1 if p1 >= _M["default_threshold"] else 0
            return {{"predict": DOMAIN[lab] if DOMAIN else lab,
                     "p0": 1.0 - p1, "p1": p1}}
        K = _M["nclasses"]
        votes = [0.0] * K
        for t in range(len(_M["tree_feat"])):
            votes[t % K] += _walk_tree(t, bins)
        votes = [min(max(v / (len(_M["tree_feat"]) // K), 0.0), 1.0)
                 for v in votes]
        s = sum(votes) or 1.0
        p = [v / s for v in votes]
        lab = p.index(max(p))
        out = {{"predict": DOMAIN[lab] if DOMAIN else lab}}
        for k in range(K):
            out["p%d" % k] = p[k]
        return out
    # gbm
    if cat == "Multinomial":
        m = _margins(bins)
        z = [f + mm for f, mm in zip(_M["f0"], m)]
        mx = max(z)
        e = [_math.exp(v - mx) for v in z]
        s = sum(e)
        p = [v / s for v in e]
        lab = p.index(max(p))
        out = {{"predict": DOMAIN[lab] if DOMAIN else lab}}
        for k in range(len(p)):
            out["p%d" % k] = p[k]
        return out
    marg = _M["f0"] + _margins(bins)[0]
    if cat == "Binomial":
        p1 = 1.0 / (1.0 + _math.exp(-marg))
        lab = 1 if p1 >= _M["default_threshold"] else 0
        return {{"predict": DOMAIN[lab] if DOMAIN else lab,
                 "p0": 1.0 - p1, "p1": p1}}
    dist = _M["distribution"]
    if dist in ("poisson", "gamma", "tweedie"):
        return {{"predict": _math.exp(marg)}}
    return {{"predict": marg}}


def predict(rows):
    return [score0(r) for r in rows]
'''


_DESIGN_HELPERS = '''
def _design_row(row):
    """One-hot expand + impute + standardize with TRAINING stats."""
    xs = []
    ni = 0
    use_all = _M["use_all_factor_levels"]
    for i, name in enumerate(NAMES):
        dom = _M["feature_domains"][i]
        v = row.get(name)
        if dom is not None:
            try:
                code = dom.index(str(v)) if v is not None else -1
            except ValueError:
                code = -1
            first = 0 if use_all else 1
            for lvl in range(first, max(len(dom), 1)):
                xs.append(1.0 if code == lvl else 0.0)
        else:
            try:
                x = float(v)
            except (TypeError, ValueError):
                x = float("nan")
            mu = _M["num_means"][ni]
            sd = _M["num_sigmas"][ni]
            ni += 1
            if x != x:
                x = mu
            if _M["standardize"]:
                x = (x - mu) / (sd if sd > 0 else 1.0)
            xs.append(x)
    return xs
'''


_GLM_TEMPLATE = ('''"""Generated by h2o3-tpu — standalone glm scorer.

Usage:  from {modname} import score0
No dependencies beyond the Python stdlib.
"""

import json as _json
import math as _math

_M = _json.loads({meta_json_literal})

NAMES = _M["names"]
DOMAIN = _M["domain"]
''' + _DESIGN_HELPERS + '''

def _link_inv(eta):
    link = _M["link"]
    if link == "logit":
        return 1.0 / (1.0 + _math.exp(-eta))
    if link in ("log", "tweedie"):
        return _math.exp(eta)
    if link == "inverse":
        return 1.0 / (eta if abs(eta) > 1e-12 else 1e-12)
    return eta


def score0(row):
    xs = _design_row(row) + [1.0]    # + intercept
    if _M.get("coef_multinomial"):
        C = _M["coef_multinomial"]
        etas = [sum(x * c for x, c in zip(xs, col)) for col in C]
        mx = max(etas)
        e = [_math.exp(v - mx) for v in etas]
        s = sum(e)
        p = [v / s for v in e]
        lab = p.index(max(p))
        out = {{"predict": DOMAIN[lab] if DOMAIN else lab}}
        for k in range(len(p)):
            out["p%d" % k] = p[k]
        return out
    eta = sum(x * c for x, c in zip(xs, _M["coef"]))
    mu = _link_inv(eta)
    if _M["category"] == "Binomial":
        lab = 1 if mu >= _M["default_threshold"] else 0
        return {{"predict": DOMAIN[lab] if DOMAIN else lab,
                 "p0": 1.0 - mu, "p1": mu}}
    return {{"predict": mu}}


def predict(rows):
    return [score0(r) for r in rows]
''')




_DL_TEMPLATE = ('''"""Generated by h2o3-tpu — standalone deeplearning scorer.

Usage:  from {modname} import score0
No dependencies beyond the Python stdlib.
"""

import json as _json
import math as _math

_M = _json.loads({meta_json_literal})

NAMES = _M["names"]
DOMAIN = _M["domain"]

''' + _DESIGN_HELPERS + '''

def _forward(xs):
    h = xs
    n_layers = len(_M["weights"])
    act = _M["activation"]
    for li in range(n_layers):
        W, b = _M["weights"][li], _M["biases"][li]
        z = [sum(h[i] * W[i][j] for i in range(len(h))) + b[j]
             for j in range(len(b))]
        if li == n_layers - 1:
            return z
        if act == "maxout":
            z = [max(z[2 * j], z[2 * j + 1]) for j in range(len(z) // 2)]
        elif act == "tanh":
            z = [_math.tanh(v) for v in z]
        else:
            z = [v if v > 0 else 0.0 for v in z]
        h = z
    return h


def score0(row):
    out = _forward(_design_row(row))
    cat = _M["category"]
    if cat in ("Binomial", "Multinomial"):
        mx = max(out)
        e = [_math.exp(v - mx) for v in out]
        s = sum(e)
        p = [v / s for v in e]
        if cat == "Binomial":
            lab = 1 if p[1] >= _M["default_threshold"] else 0
            return {{"predict": DOMAIN[lab] if DOMAIN else lab,
                     "p0": p[0], "p1": p[1]}}
        lab = p.index(max(p))
        o = {{"predict": DOMAIN[lab] if DOMAIN else lab}}
        for k in range(len(p)):
            o["p%d" % k] = p[k]
        return o
    mu, sd = _M["resp_stats"]
    return {{"predict": out[0] * sd + mu}}


def predict(rows):
    return [score0(r) for r in rows]
''')

_KMEANS_TEMPLATE = ('''"""Generated by h2o3-tpu — standalone kmeans scorer.

Usage:  from {modname} import score0
No dependencies beyond the Python stdlib.
"""

import json as _json

_M = _json.loads({meta_json_literal})

NAMES = _M["names"]
DOMAIN = None

''' + _DESIGN_HELPERS + '''

def score0(row):
    xs = _design_row(row)
    best, bd = 0, None
    for ci, c in enumerate(_M["centers"]):
        d = sum((a - b) ** 2 for a, b in zip(xs, c))
        if bd is None or d < bd:
            best, bd = ci, d
    return {{"predict": best}}


def predict(rows):
    return [score0(r) for r in rows]
''')


def pojo_source(model, modname: str = "model_pojo") -> str:
    """Render the standalone scorer source for a trained model."""
    from h2o3_tpu_torch.genmodel.export import mojo_artifacts
    meta, arrays = mojo_artifacts(model)
    algo = meta["algo"]
    if algo in ("gbm", "drf"):
        edges = arrays["edges"]
        m = {
            "algo": algo,
            "category": str(meta["category"]),
            "names": meta["names"],
            "domain": meta.get("domain"),
            "nclasses": int(meta.get("nclasses") or 1),
            "default_threshold": float(meta.get("default_threshold", 0.5)),
            "nbins_total": int(meta["nbins_total"]),
            "feature_domains": meta["feature_domains"],
            "is_cat": arrays["is_cat"].astype(bool).tolist(),
            "nbins": arrays["nbins"].astype(int).tolist(),
            "edges": [[float(e) for e in row if np.isfinite(e)]
                      for row in edges],
            "tree_feat": arrays["tree_feat"].astype(int).tolist(),
            "tree_thresh": arrays["tree_thresh"].astype(int).tolist(),
            "tree_na_left": arrays["tree_na_left"].astype(bool).tolist(),
            "tree_is_split": arrays["tree_is_split"].astype(bool).tolist(),
            "tree_leaf": arrays["tree_leaf"].astype(float).tolist(),
            "tree_cat_split": (arrays["tree_cat_split"].astype(bool).tolist()
                               if "tree_cat_split" in arrays else None),
            "tree_left_words": (arrays["tree_left_words"].astype(int).tolist()
                                if "tree_left_words" in arrays else None),
            "f0": (meta.get("f0") if algo == "gbm" else None),
            "distribution": meta.get("distribution", "gaussian"),
        }
        return _TREE_TEMPLATE.format(algo=algo, modname=modname,
                                     meta_json_literal=repr(json.dumps(m)))
    if algo == "glm":
        m = {
            "algo": "glm",
            "category": str(meta["category"]),
            "names": meta["names"],
            "domain": meta.get("domain"),
            "default_threshold": float(meta.get("default_threshold", 0.5)),
            "feature_domains": meta["feature_domains"],
            "standardize": bool(meta.get("standardize", True)),
            "use_all_factor_levels": bool(
                meta.get("use_all_factor_levels", False)),
            "link": meta.get("link", "identity"),
            "num_means": arrays["num_means"].astype(float).tolist(),
            "num_sigmas": arrays["num_sigmas"].astype(float).tolist(),
            "coef": (arrays["coef"].astype(float).tolist()
                     if "coef" in arrays else None),
            "coef_multinomial": (
                arrays["coef_multinomial"].T.astype(float).tolist()
                if "coef_multinomial" in arrays else None),
        }
        return _GLM_TEMPLATE.format(modname=modname,
                                    meta_json_literal=repr(json.dumps(m)))
    if algo == "deeplearning":
        if meta.get("autoencoder"):
            raise ValueError("POJO export does not cover autoencoders "
                             "(use download_mojo)")
        n_layers = int(meta["n_layers"])
        m = {
            "algo": "deeplearning",
            "category": str(meta["category"]),
            "names": meta["names"],
            "domain": meta.get("domain"),
            "default_threshold": float(meta.get("default_threshold", 0.5)),
            "feature_domains": meta["feature_domains"],
            "standardize": bool(meta.get("standardize", True)),
            "use_all_factor_levels": bool(
                meta.get("use_all_factor_levels", False)),
            "activation": meta.get("activation", "rectifier"),
            "num_means": arrays["num_means"].astype(float).tolist(),
            "num_sigmas": arrays["num_sigmas"].astype(float).tolist(),
            "weights": [arrays[f"W{i}"].astype(float).tolist()
                        for i in range(n_layers)],
            "biases": [arrays[f"b{i}"].astype(float).tolist()
                       for i in range(n_layers)],
            "resp_stats": meta.get("resp_stats") or [0.0, 1.0],
        }
        return _DL_TEMPLATE.format(modname=modname,
                                   meta_json_literal=repr(json.dumps(m)))
    if algo == "kmeans":
        m = {
            "algo": "kmeans",
            "category": "Clustering",
            "names": meta["names"],
            "feature_domains": meta["feature_domains"],
            "standardize": bool(meta.get("standardize", True)),
            "use_all_factor_levels": True,
            "num_means": arrays["num_means"].astype(float).tolist(),
            "num_sigmas": arrays["num_sigmas"].astype(float).tolist(),
            "centers": arrays["centers"].astype(float).tolist(),
        }
        return _KMEANS_TEMPLATE.format(modname=modname,
                                       meta_json_literal=repr(json.dumps(m)))
    raise ValueError(f"POJO export not supported for algo '{algo}' "
                     "(use download_mojo)")


def export_pojo(model, path: str) -> str:
    """Write the generated scorer module to ``path`` (Model.toJava role)."""
    import os
    modname = os.path.splitext(os.path.basename(path))[0]
    with open(path, "w") as fh:
        fh.write(pojo_source(model, modname=modname))
    return path
