"""Naive Bayes — class-conditional counts and moments.

Reference: h2o3_tpu/models/naivebayes.py (hex/naivebayes/NaiveBayes.java):
the priors, each numeric's per-class mean and deviation (a Gaussian
likelihood) and each categorical's per-class level table (Laplace
smoothing ``laplace``), with the ``min_sdev``/``eps_sdev`` and
``min_prob`` floors. Each kind of statistic is ONE ``segment_sum`` on the
frame's device (fixed point on the card): {w, w·x, w·x²} of every numeric
by class, a categorical's weights by (class, level), the class weights.
The small per-class arithmetic after the sums is the reference's float32
numpy on the host. Scoring evaluates the reference's float32
log-likelihood expression on the frame's device; a binomial model labels
by its max-F1 threshold. The metrics are ``models/metrics.py``'s;
``nfolds`` takes ``ml/cv.py``'s supervised path.

Accepted and inert, as in the reference: ``eps_prob``,
``compute_metrics`` and ``weights_column`` (the fit weighs every row
with a response 1). Not ported: Naive Bayes on a frame partitioned over
a sharded mesh (ROADMAP A #12′). Its MOJO is ``Model.download_mojo``'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain, infer_category,
                                         masked_weights)
from h2o3_tpu_torch.ops.segments import segment_sum
from h2o3_tpu_torch.parallel.device import fetch


class NaiveBayesModel(Model):
    algo = "naivebayes"

    def __init__(self, params, output, stats):
        super().__init__(params, output)
        # priors, num_names / num_mu / num_sd (per class), cat_names /
        # cat_tables ([K, card] conditional probabilities) / cat_domains
        self.stats = stats

    def _probs(self, frame: Frame) -> torch.Tensor:
        """[nrows, K] class probabilities on the frame's device, from the
        float32 log-likelihood."""
        s, p = self.stats, self.params
        n, dev = frame.nrows, frame.device

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        ll = torch.log(torch.clamp_min(f32(s["priors"]), 1e-12))[
            None, :].repeat(n, 1)
        eps = float(p.get("eps_sdev") or 0.0)
        min_sd = max(float(p.get("min_sdev") or 1e-3), 1e-6)
        for j, name in enumerate(s["num_names"]):
            x = frame.col(name).numeric_view()[:n]
            sd = torch.clamp_min(f32(s["num_sd"][j]), min_sd) + eps
            t = (x[:, None] - f32(s["num_mu"][j])[None, :]) / sd[None, :]
            contrib = -0.5 * t * t - torch.log(sd)[None, :]
            ll += torch.where(torch.isnan(x)[:, None], 0.0, contrib)
        min_p = max(float(p.get("min_prob") or 1e-3), 1e-10)
        for j, name in enumerate(s["cat_names"]):
            codes = torch.from_numpy(adapt_domain(
                frame.col(name), s["cat_domains"][j]).astype(np.int64)).to(dev)
            logp = torch.log(torch.clamp_min(f32(s["cat_tables"][j]), min_p))
            contrib = logp.T.index_select(0, torch.clamp_min(codes, 0))
            ll += torch.where((codes < 0)[:, None], 0.0, contrib)
        e = torch.exp(ll - ll.max(dim=1, keepdim=True).values)
        return e / e.sum(dim=1, keepdim=True)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        p = fetch(self._probs(frame))
        if p.shape[1] == 2:
            # a binomial label honors the default threshold
            t = self.output.get("default_threshold", 0.5)
            out = {"predict": (p[:, 1] >= t).astype(np.int32)}
        else:
            out = {"predict": p.argmax(axis=1).astype(np.int32)}
        for k in range(p.shape[1]):
            out[f"p{k}"] = p[:, k]
        return out

    def model_performance(self, frame: Frame, mask_weights=None):
        p = self._probs(frame)
        n = frame.nrows
        yv = adapt_domain(frame.col(self.output["response"]),
                          self.output["domain"])
        w = masked_weights(frame.valid_weights(), mask_weights)[:n] * \
            torch.from_numpy((yv >= 0).astype(np.float32)).to(p.device)
        yt = torch.from_numpy(np.maximum(yv, 0)).to(p.device)
        if p.shape[1] == 2:
            return mm.binomial_metrics(p[:, 1], yt.to(torch.float32), w)
        return mm.multinomial_metrics(p, yt, w, domain=self.output["domain"])


class NaiveBayesEstimator(ModelBuilder):
    """h2o-py H2ONaiveBayesEstimator surface."""

    algo = "naivebayes"
    label = "NaiveBayes"

    DEFAULTS = dict(
        laplace=0.0, min_sdev=1e-3, eps_sdev=0.0, min_prob=1e-3,
        eps_prob=0.0, seed=-1, nfolds=0, fold_column=None,
        fold_assignment="auto", ignored_columns=None, weights_column=None,
        compute_metrics=True,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        category = infer_category(frame, y)
        if category == ModelCategory.REGRESSION:
            raise ValueError("NaiveBayes requires a categorical response")
        rc = frame.col(y)
        K = rc.cardinality
        cls = rc.data.long()                 # an NA response is class 0 ...
        w = frame.valid_weights() * (~rc.na_mask).to(torch.float32)  # ... at 0
        lap = float(p["laplace"])

        num_names = [c for c in x if not frame.col(c).is_categorical]
        cat_names = [c for c in x if frame.col(c).is_categorical]
        num_mu, num_sd = [], []
        if num_names:
            cols = []
            for name in num_names:
                v = frame.col(name).numeric_view()
                valid = ~torch.isnan(v)
                v0 = torch.where(valid, v, 0.0)
                cols += [w * valid, w * v0, w * v0 * v0]
            sums = fetch(segment_sum(cls, torch.stack(cols, 1), n_nodes=K))
            for j in range(len(num_names)):
                cw, cx, cxx = sums[:, 3 * j], sums[:, 3 * j + 1], \
                    sums[:, 3 * j + 2]
                mu = cx / np.maximum(cw, 1e-12)
                var = cxx / np.maximum(cw, 1e-12) - mu * mu
                num_mu.append(mu)
                num_sd.append(np.sqrt(np.maximum(var, 1e-12)))
        cat_tables, cat_domains = [], []
        for name in cat_names:
            c = frame.col(name)
            card = max(c.cardinality, 1)
            idx = cls * card + torch.clamp(c.data.long(), 0, card - 1)
            wna = w * (~c.na_mask).to(torch.float32)
            tab = fetch(segment_sum(idx, wna[:, None],
                                    n_nodes=K * card)).reshape(K, card)
            tab = (tab + lap) / np.maximum(
                tab.sum(axis=1, keepdims=True) + lap * card, 1e-12)
            cat_tables.append(tab)
            cat_domains.append(c.domain)
        prior_w = fetch(segment_sum(cls, w[:, None], n_nodes=K))[:, 0]
        priors = prior_w / max(prior_w.sum(), 1e-12)

        stats = {"priors": priors, "num_names": num_names,
                 "num_mu": num_mu, "num_sd": num_sd,
                 "cat_names": cat_names, "cat_tables": cat_tables,
                 "cat_domains": cat_domains}
        output = {"category": category, "response": y, "names": list(x),
                  "nclasses": K, "domain": rc.domain,
                  "priors": priors.tolist()}
        model = NaiveBayesModel(p, output, stats)
        model.training_metrics = model.model_performance(frame)
        if category == ModelCategory.BINOMIAL:
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        return model
