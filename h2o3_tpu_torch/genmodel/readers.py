"""Offline MOJO scoring runtime — numpy-only, no JAX / no device.

The port's copy of h2o3_tpu/genmodel/readers.py; the port imports nothing
of the reference package, so it keeps its own.

Reference: hex/genmodel/MojoModel.java:12 + per-algo readers under
hex/genmodel/algos/{gbm,drf,glm,deeplearning,kmeans,isofor}; the
scoring contract is GenModel.score0 (hex/genmodel/GenModel.java:363):
raw row in, prediction vector out, with the same categorical-domain and
NA semantics as in-cluster scoring.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.genmodel.mojo import (bin_raw, design_matrix, read_mojo,
                                    walk_forest)


class MojoModel:
    """Loaded offline model (hex/genmodel/MojoModel.java role)."""

    def __init__(self, meta: dict, arrays: Dict[str, np.ndarray]):
        self.meta = meta
        self.arrays = arrays

    # -- introspection -------------------------------------------------
    @property
    def algo(self) -> str:
        return self.meta["algo"]

    @property
    def category(self) -> str:
        return self.meta["category"]

    @property
    def names(self) -> List[str]:
        return self.meta["names"]

    @property
    def domain(self) -> Optional[List[str]]:
        return self.meta.get("domain")

    @property
    def nclasses(self) -> int:
        return int(self.meta.get("nclasses") or 1)

    # -- scoring -------------------------------------------------------
    def predict(self, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Batch scoring on dict-of-raw-columns → dict of predictions,
        matching the in-cluster ``model.predict`` column layout."""
        raise NotImplementedError

    def score0(self, row: dict) -> dict:
        """Single-row score (GenModel.score0)."""
        batch = {k: np.asarray([v]) for k, v in row.items()}
        out = self.predict(batch)
        return {k: v[0] for k, v in out.items()}

    # -- loading -------------------------------------------------------
    @staticmethod
    def load(path: str) -> "MojoModel":
        meta, arrays = read_mojo(path)
        cls = _READERS.get(meta["algo"])
        if cls is None:
            raise ValueError(f"no MOJO reader for algo '{meta['algo']}'")
        return cls(meta, arrays)


def _softmax(z):
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _class_output(p: np.ndarray, threshold: float, domain) -> dict:
    if p.shape[1] == 2:
        lab = (p[:, 1] >= threshold).astype(np.int32)
        return {"predict": lab, "p0": p[:, 0], "p1": p[:, 1]}
    out = {"predict": p.argmax(axis=1).astype(np.int32)}
    for k in range(p.shape[1]):
        out[f"p{k}"] = p[:, k]
    return out


def _link_inv(name: str, eta: np.ndarray, tweedie_power: float = 1.5):
    if name in ("identity", "gaussian", "laplace", "quantile", "huber"):
        return eta
    if name in ("logit", "bernoulli", "binomial", "quasibinomial"):
        return 1.0 / (1.0 + np.exp(-eta))
    if name in ("log", "poisson", "gamma", "tweedie"):
        return np.exp(eta)
    if name == "inverse":
        return 1.0 / np.where(np.abs(eta) < 1e-12, 1e-12, eta)
    return eta


class SharedTreeMojoModel(MojoModel):
    """GBM/DRF/IsolationForest share the stored-forest walk
    (hex/genmodel/algos/tree/SharedTreeMojoModel role)."""

    def _tree_sums(self, data) -> np.ndarray:
        B = int(self.meta["nbins_total"])
        bins = bin_raw(self.meta, self.arrays, data)
        return walk_forest(self.arrays, bins, B)   # [T_total, N]

    def predict_contributions(self, data) -> Dict[str, np.ndarray]:
        """Offline TreeSHAP (hex/genmodel/algos/tree/TreeSHAP.java role):
        feature columns + BiasTerm, summing to the raw margin."""
        import torch

        from h2o3_tpu_torch.ml.shap import forest_contributions
        from h2o3_tpu_torch.models.tree import Tree
        cat = self.category
        if cat not in ("Regression", "Binomial"):
            raise ValueError(
                "predict_contributions supports only regression and "
                f"binomial models (got {cat})")
        if "tree_leaf_w" not in self.arrays:
            raise ValueError("MOJO lacks node weights "
                             "(exported before TreeSHAP support)")
        B = int(self.meta["nbins_total"])
        bins = bin_raw(self.meta, self.arrays, data)
        a = self.arrays
        tf = a["tree_feat"]
        cs = a.get("tree_cat_split", np.zeros(tf.shape, bool))
        lw = a.get("tree_left_words", np.zeros(tf.shape + (1,), np.uint32))
        # the port's TreeSHAP on a CPU forest (left words as int32 bits)
        forest = Tree(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            tf.astype(np.int32), a["tree_thresh"].astype(np.int32),
            a["tree_na_left"].astype(bool), a["tree_is_split"].astype(bool),
            a["tree_leaf"].astype(np.float32),
            a["tree_leaf_w"].astype(np.float32), cs.astype(bool),
            lw.astype(np.uint32).view(np.int32))))
        T = tf.shape[0]
        scale = 1.0 / T if self.algo == "drf" else 1.0
        phi = forest_contributions(forest, torch.from_numpy(bins), B,
                                   scale=scale)
        if self.algo == "gbm":
            phi[:, -1] += float(np.asarray(self.meta["f0"], np.float64))
        out = {n: phi[:, j] for j, n in enumerate(self.names)}
        out["BiasTerm"] = phi[:, -1]
        return out


class GbmMojoModel(SharedTreeMojoModel):
    def predict(self, data):
        per_tree = self._tree_sums(data)
        f0 = np.asarray(self.meta["f0"], dtype=np.float64)
        cat = self.category
        if cat == "Multinomial":
            K = self.nclasses
            T = per_tree.shape[0] // K
            marg = f0[None, :] + per_tree.reshape(T, K, -1).sum(axis=0).T
            return _class_output(_softmax(marg), 0.5, self.domain)
        marg = float(f0) + per_tree.sum(axis=0)
        if cat == "Binomial":
            p1 = 1.0 / (1.0 + np.exp(-marg))
            p = np.stack([1 - p1, p1], axis=1)
            return _class_output(p, self.meta.get("default_threshold", 0.5),
                                 self.domain)
        mu = _link_inv(self.meta.get("distribution", "gaussian"), marg,
                       self.meta.get("tweedie_power", 1.5))
        return {"predict": mu}


class DrfMojoModel(SharedTreeMojoModel):
    def predict(self, data):
        per_tree = self._tree_sums(data)
        cat = self.category
        if cat == "Regression":
            return {"predict": per_tree.mean(axis=0)}
        if cat == "Binomial":
            p1 = np.clip(per_tree.mean(axis=0), 0.0, 1.0)
            p = np.stack([1 - p1, p1], axis=1)
            return _class_output(p, self.meta.get("default_threshold", 0.5),
                                 self.domain)
        K = self.nclasses
        T = per_tree.shape[0] // K
        votes = per_tree.reshape(T, K, -1).mean(axis=0).T   # [N, K]
        votes = np.clip(votes, 0.0, 1.0)
        p = votes / np.maximum(votes.sum(axis=1, keepdims=True), 1e-12)
        return _class_output(p, 0.5, self.domain)


class IsoForMojoModel(SharedTreeMojoModel):
    def predict(self, data):
        from h2o3_tpu_torch.genmodel.mojo import bin_raw, walk_forest_pathlen
        B = int(self.meta["nbins_total"])
        bins = bin_raw(self.meta, self.arrays, data)
        per_tree = walk_forest_pathlen(self.arrays, bins, B)
        ml = per_tree.mean(axis=0)
        mn = self.meta.get("min_path_length")
        mx = self.meta.get("max_path_length")
        if mn is not None and mx is not None and float(mx) > float(mn):
            # reference normalization against the training frame's
            # path-length extrema — the exact math of the in-cluster
            # scorer (models/isofor.py _score_raw)
            ntrees = per_tree.shape[0]
            score = (float(mx) - ml * ntrees) / (float(mx) - float(mn))
        else:
            c = max(float(self.meta["c_norm"]), 1e-12)
            score = 2.0 ** (-ml / c)
        return {"predict": score, "mean_length": ml}


class GlmMojoModel(MojoModel):
    def predict(self, data):
        X = design_matrix(self.meta, self.arrays, data)
        X1 = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        if "coef_multinomial" in self.arrays:
            eta = X1 @ self.arrays["coef_multinomial"]
            return _class_output(_softmax(eta), 0.5, self.domain)
        eta = X1 @ self.arrays["coef"]
        link = self.meta.get("link", "identity")
        mu = _link_inv(link, eta, self.meta.get("tweedie_power", 1.5))
        if self.category == "Binomial":
            p = np.stack([1 - mu, mu], axis=1)
            return _class_output(p, self.meta.get("default_threshold", 0.5),
                                 self.domain)
        return {"predict": mu}


class DeepLearningMojoModel(MojoModel):
    def _forward(self, X: np.ndarray) -> np.ndarray:
        act = self.meta.get("activation", "rectifier")
        n_layers = int(self.meta["n_layers"])
        h = X
        for i in range(n_layers):
            z = h @ self.arrays[f"W{i}"] + self.arrays[f"b{i}"]
            if i == n_layers - 1:
                return z
            if act == "maxout":
                z = z.reshape(z.shape[0], -1, 2).max(axis=2)
            elif act == "tanh":
                z = np.tanh(z)
            else:
                z = np.maximum(z, 0.0)
            h = z
        return h

    def predict(self, data):
        X = design_matrix(self.meta, self.arrays, data)
        out = self._forward(X)
        cat = self.category
        if self.meta.get("autoencoder"):
            return {"reconstruction_error": np.mean((out - X) ** 2, axis=1)}
        if cat in ("Binomial", "Multinomial"):
            p = _softmax(out)
            return _class_output(p, self.meta.get("default_threshold", 0.5),
                                 self.domain)
        mu, sd = self.meta["resp_stats"]
        return {"predict": out[:, 0] * sd + mu}


class KMeansMojoModel(MojoModel):
    def predict(self, data):
        X = design_matrix(self.meta, self.arrays, data)
        C = self.arrays["centers"]
        d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        return {"predict": d2.argmin(axis=1).astype(np.int32)}


class PcaMojoModel(MojoModel):
    def predict(self, data):
        X = design_matrix(self.meta, self.arrays, data)
        if self.algo == "pca":
            scores = X @ self.arrays["eigvecs"]
            return {f"PC{i + 1}": scores[:, i]
                    for i in range(scores.shape[1])}
        proj = X @ self.arrays["v"]
        u = proj / np.maximum(self.arrays["d"][None, :], 1e-12)
        return {f"u{i + 1}": u[:, i] for i in range(u.shape[1])}


class IsotonicMojoModel(MojoModel):
    def predict(self, data):
        x = np.asarray(data[self.names[0]], dtype=np.float64)
        tx, ty = self.arrays["thresholds_x"], self.arrays["thresholds_y"]
        pred = np.interp(np.clip(x, tx[0], tx[-1]), tx, ty)
        pred[np.isnan(x)] = np.nan
        if str(self.meta.get("out_of_bounds", "clip")).lower() == "na":
            pred[(x < tx[0]) | (x > tx[-1])] = np.nan
        return {"predict": pred}


class CoxPHMojoModel(MojoModel):
    def predict(self, data):
        X = design_matrix(self.meta, self.arrays, data)
        lp = X @ self.arrays["coef"] - self.meta["eta_mean"]
        return {"lp": lp}


class NaiveBayesMojoModel(MojoModel):
    def predict(self, data):
        priors = self.arrays["priors"]
        K = len(priors)
        num_names = self.meta["num_names"]
        cat_names = self.meta["cat_names"]
        n = len(np.asarray(data[(num_names + cat_names)[0]]))
        ll = np.log(np.maximum(priors, 1e-12))[None, :].repeat(n, 0)
        min_sd = max(self.meta["min_sdev"], 1e-6)
        eps = self.meta["eps_sdev"]
        for j, name in enumerate(num_names):
            x = np.asarray(data[name], dtype=np.float64)
            mu = self.arrays["num_mu"][j]
            sd = np.maximum(self.arrays["num_sd"][j], min_sd) + eps
            t = (x[:, None] - mu[None, :]) / sd[None, :]
            contrib = -0.5 * t * t - np.log(sd)[None, :]
            ll += np.where(np.isnan(x)[:, None], 0.0, contrib)
        min_p = max(self.meta["min_prob"], 1e-10)
        for j, name in enumerate(cat_names):
            dom = self.meta["cat_domains"][j]
            lut = {lvl: i for i, lvl in enumerate(dom)}
            v = np.asarray(data[name])
            codes = np.array([lut.get(str(x), -1) if x is not None else -1
                              for x in v], dtype=np.int64)
            probs = np.maximum(self.arrays[f"cat_table_{j}"], min_p)
            contrib = np.log(probs[:, np.maximum(codes, 0)]).T
            ll += np.where((codes < 0)[:, None], 0.0, contrib)
        p = np.exp(ll - ll.max(axis=1, keepdims=True))
        p = p / p.sum(axis=1, keepdims=True)
        # _class_output only consults the threshold in the 2-class case
        return _class_output(p, self.meta.get("default_threshold", 0.5),
                             self.domain)


class UpliftDrfMojoModel(SharedTreeMojoModel):
    def predict(self, data):
        B = int(self.meta["nbins_total"])
        bins = bin_raw(self.meta, self.arrays, data)
        pt = walk_forest({**self.arrays,
                          "tree_leaf": self.arrays["leaf_pt"]},
                         bins, B).mean(axis=0)
        pc = walk_forest({**self.arrays,
                          "tree_leaf": self.arrays["leaf_pc"]},
                         bins, B).mean(axis=0)
        return {"uplift_predict": pt - pc, "p_y1_ct1": pt, "p_y1_ct0": pc}


class ExtIsoForMojoModel(MojoModel):
    def predict(self, data):
        names = self.names
        means = self.arrays["col_means"]
        X = np.stack([np.asarray(data[n], dtype=np.float64)
                      for n in names], axis=1)
        for j in range(X.shape[1]):
            X[np.isnan(X[:, j]), j] = means[j]
        normals = self.arrays["ext_normals"]     # [T, D, L, F]
        offsets = self.arrays["ext_offsets"]
        is_split = self.arrays["ext_is_split"].astype(bool)
        leaf = self.arrays["ext_leaf"]
        T, D = normals.shape[0], normals.shape[1]
        n = X.shape[0]
        tot = np.zeros(n)
        for t in range(T):
            nid = np.zeros(n, dtype=np.int64)
            plen = np.zeros(n)
            for d in range(D):
                isp = is_split[t, d][nid]
                plen += isp
                Wr = normals[t, d][nid]
                proj = (X * Wr).sum(axis=1)
                goleft = np.where(isp, proj < offsets[t, d][nid], True)
                nid = 2 * nid + np.where(goleft, 0, 1)
            tot += plen + leaf[t][nid]
        ml = tot / T
        c = max(float(self.meta["c_norm"]), 1e-12)
        return {"anomaly_score": 2.0 ** (-ml / c), "mean_length": ml}


class GlrmMojoModel(MojoModel):
    def predict(self, data):
        """Project rows onto the archetypes: ridge solve of X ≈ A·Y with
        NA cells excluded per row (hex/genmodel/algos/glrm scoring role)."""
        X = design_matrix(self.meta, self.arrays, data)
        Y = self.arrays["archetypes"]            # [k, P]
        k = Y.shape[0]
        lam = 1e-6
        # NA mask in the expanded space: numeric NAs were mean-imputed by
        # design_matrix, so recover them from the raw columns
        n = X.shape[0]
        ok = np.ones_like(X, dtype=bool)
        col_idx = 0
        domains = self.meta.get("feature_domains") or [None] * len(self.names)
        for i, name in enumerate(self.names):
            dom = domains[i]
            # widths must mirror design_matrix exactly (card floor of 1)
            width = max(len(dom), 1) if dom is not None else 1
            v = np.asarray(data[name])
            if dom is None:
                isna = np.isnan(v.astype(np.float64))
            else:
                # same missing test design_matrix applies: None, NaN, or
                # a level outside the training domain all encode to -1
                domset = set(dom)
                isna = np.asarray([
                    x is None
                    or (isinstance(x, float) and np.isnan(x))
                    or str(x) not in domset
                    for x in v])
            ok[isna, col_idx: col_idx + width] = False
            col_idx += width
        A = np.zeros((n, k))
        G_full = Y @ Y.T + lam * np.eye(k)
        full = ok.all(axis=1)
        if full.any():
            A[full] = np.linalg.solve(G_full, Y @ X[full].T).T
        for r in np.where(~full)[0]:
            m = ok[r]
            Ym = Y[:, m]
            A[r] = np.linalg.solve(Ym @ Ym.T + lam * np.eye(k),
                                   Ym @ X[r, m])
        return {f"Arch{i + 1}": A[:, i] for i in range(k)}


class Word2VecMojoModel(MojoModel):
    def predict(self, data):
        """Embed a words column: NaN/None rows delimit sequences only in
        transform()-style use; here NONE semantics (one vector per word,
        NaN row for unknown)."""
        vocab = self.meta["vocab"]
        index = {w: i for i, w in enumerate(vocab)}
        vec = self.arrays["vectors"]
        words = np.asarray(data[self.names[0]] if self.names
                           else data["words"])
        D = vec.shape[1]
        out = np.full((len(words), D), np.nan)
        for i, w in enumerate(words):
            j = index.get(w if isinstance(w, str) else None)
            if j is not None:
                out[i] = vec[j]
        return {f"V{i + 1}": out[:, i] for i in range(D)}

    def find_synonyms(self, word: str, count: int = 20):
        vec = self.arrays["vectors"]
        index = {w: i for i, w in enumerate(self.meta["vocab"])}
        if word not in index:
            return {}
        v = vec[index[word]]
        sims = vec @ v / np.maximum(
            np.linalg.norm(vec, axis=1) * max(np.linalg.norm(v), 1e-12),
            1e-12)
        order = np.argsort(-sims)
        out = {}
        for i in order:
            w = self.meta["vocab"][i]
            if w == word:
                continue
            out[w] = float(sims[i])
            if len(out) >= count:
                break
        return out


class RuleFitMojoModel(MojoModel):
    """Composite offline scorer: rebuild the rule/linear feature columns
    from the bundled rule forests, then score the bundled GLM head."""

    def _features(self, data) -> Dict[str, np.ndarray]:
        from h2o3_tpu_torch.genmodel.mojo import route_tree_nids
        feats: Dict[str, np.ndarray] = {}
        rules = self.meta["rules"]
        for i in range(int(self.meta["n_tree_models"])):
            sub_meta = {"names": self.meta[f"tm{i}_names"],
                        "nbins_total": self.meta[f"tm{i}_nbins_total"],
                        "feature_domains": self.meta[f"tm{i}_feature_domains"]}
            pre = f"tm{i}_"
            sub_arrays = {k[len(pre):]: v for k, v in self.arrays.items()
                          if k.startswith(pre)}
            B = int(sub_meta["nbins_total"])
            bins = bin_raw(sub_meta, sub_arrays, data)
            my_rules = [r for r in rules if r["model"] == i]
            by_tree: Dict[int, list] = {}
            for r in my_rules:
                by_tree.setdefault(int(r["tree"]), []).append(r)
            for t, rl in sorted(by_tree.items()):
                cs = sub_arrays.get("tree_cat_split")
                lw = sub_arrays.get("tree_left_words")
                nid = route_tree_nids(
                    sub_arrays["tree_feat"][t], sub_arrays["tree_thresh"][t],
                    sub_arrays["tree_na_left"][t].astype(bool),
                    sub_arrays["tree_is_split"][t].astype(bool), bins, B,
                    None if cs is None else cs[t].astype(bool),
                    None if lw is None else lw[t])
                for r in rl:
                    feats[r["name"]] = ((nid >= r["lo"]) & (nid < r["hi"])
                                        ).astype(np.float64)
        for n in self.meta.get("linear_cols") or []:
            lo, hi = self.meta["winsor"][n]
            v = np.asarray(data[n], dtype=np.float64)
            feats[f"linear.{n}"] = np.clip(v, lo, hi)
        return feats

    def predict(self, data):
        glm_arrays = {k[4:]: v for k, v in self.arrays.items()
                      if k.startswith("glm_")}
        head = GlmMojoModel(self.meta["glm"], glm_arrays)
        return head.predict(self._features(data))


_READERS = {
    "gbm": GbmMojoModel,
    "drf": DrfMojoModel,
    "isolationforest": IsoForMojoModel,
    "glm": GlmMojoModel,
    "deeplearning": DeepLearningMojoModel,
    "kmeans": KMeansMojoModel,
    "pca": PcaMojoModel,
    "svd": PcaMojoModel,
    "isotonicregression": IsotonicMojoModel,
    "coxph": CoxPHMojoModel,
    "naivebayes": NaiveBayesMojoModel,
    "upliftdrf": UpliftDrfMojoModel,
    "extendedisolationforest": ExtIsoForMojoModel,
    "word2vec": Word2VecMojoModel,
    "glrm": GlrmMojoModel,
    "rulefit": RuleFitMojoModel,
}
