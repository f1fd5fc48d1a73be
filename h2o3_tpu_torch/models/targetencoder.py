"""Target encoding — categorical levels → the response's level means.

Reference: h2o3_tpu/models/targetencoder.py (h2o-extensions'
TargetEncoder / TargetEncoderModel): at fit, per (fold, level) sums of
the response and of the row counts of each encoded categorical (ONE
``segment_sum`` over fold·card + level on the frame's device, fixed
point on the card; float64 on the host after). ``transform`` appends a
``<col>_te`` column: the level mean, blended with the prior by
λ = 1 / (1 + exp(−(n − k) / f)) under ``blending``, with leakage handling
on training rows (``none``; ``loo``, the row's own response left out;
``kfold``, the row's own fold left out) and uniform noise from
``RandomState(seed & 0xFFFFFFFF)``, the reference's numpy stream, so the
encodings, noise included, are the reference's bit for bit wherever the
sums are (integer responses and weights: always). An NA or unseen level
encodes as the prior.

The frame ``transform`` returns is the one the reference rebuilds from
its columns decoded to strings (``models/generic._frame_raw_columns``):
each categorical re-interned (the levels present, sorted), here recoded
from its codes without going through strings.

``nfolds`` >= 2 raises: the leakage control is ``kfold`` with a
``fold_column``, which does not start cross-validation.
``weights_column`` and ``fold_assignment`` are accepted and inert, as in
the reference (every row with a response weighs 1). Not ported: the
Target Encoder on a frame partitioned over a sharded mesh (ROADMAP
A #12); MOJO export (A #10).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model import Model, ModelBuilder, adapt_domain
from h2o3_tpu_torch.ops.segments import segment_sum
from h2o3_tpu_torch.parallel.device import fetch


def level_stats(codes: np.ndarray, y: np.ndarray, w: np.ndarray, card: int,
                device, folds: Optional[np.ndarray] = None,
                nfolds: int = 1):
    """Per-(fold, level) float64 (Σ w·y, Σ w), each [nfolds, card], from
    one ``segment_sum`` on ``device`` of float32 w·y and w."""
    seg = codes.astype(np.int64)
    if folds is not None:
        seg = folds.astype(np.int64) * card + seg
    nf = max(nfolds, 1)
    vals = np.stack([(w * y).astype(np.float32), w.astype(np.float32)], 1)
    s = fetch(segment_sum(torch.from_numpy(seg).to(device),
                          torch.from_numpy(vals).to(device),
                          n_nodes=card * nf)).astype(np.float64)
    return s[:, 0].reshape(nf, card), s[:, 1].reshape(nf, card)


def blend(level_sum, level_cnt, prior, k: float, f: float, blending: bool):
    mean = np.where(level_cnt > 0, level_sum / np.maximum(level_cnt, 1e-12),
                    prior)
    if not blending:
        return mean
    z = np.clip((level_cnt - k) / max(f, 1e-12), -50.0, 50.0)
    lam = 1.0 / (1.0 + np.exp(-z))
    return lam * mean + (1.0 - lam) * prior


def _reinterned(col):
    """A categorical's (codes, domain) as interning its decoded levels
    gives them: the levels present, sorted; -1 at NA."""
    host = col.host_view()
    ok = ~np.isnan(host)
    codes = np.where(ok, host, 0).astype(np.int64)
    dom = np.asarray(col.domain or [], dtype=object)
    present = np.flatnonzero(np.bincount(codes[ok], minlength=len(dom)))
    levels = sorted(str(v) for v in dom[present])
    lut = np.full(max(len(dom), 1), -1, np.int32)
    lut[present] = [levels.index(str(v)) for v in dom[present]]
    return np.where(ok, lut[codes], -1).astype(np.int32), levels


class TargetEncoderModel(Model):
    algo = "targetencoder"

    def __init__(self, params, output, enc_maps: Dict[str, dict]):
        super().__init__(params, output)
        # a column's "sum" and "cnt" [nfolds, card], "domain", "prior"
        self.enc_maps = enc_maps

    def transform(self, frame: Frame, as_training: bool = False,
                  noise: Optional[float] = None,
                  seed: Optional[int] = None) -> Frame:
        """``frame`` with a ``<col>_te`` column after its columns for each
        encoded column it has; ``as_training`` applies the leakage
        handling and the noise."""
        p = self.params
        handling = str(p.get("data_leakage_handling") or "none").lower()
        blending = bool(p.get("blending", False))
        k = float(p.get("inflection_point", 10.0))
        f = float(p.get("smoothing", 20.0))
        noise = float(p.get("noise", 0.01) if noise is None else noise)
        s = int(p.get("seed") or 0) if seed is None else int(seed)
        rng = np.random.RandomState(s & 0xFFFFFFFF)
        n = frame.nrows
        fold_col = p.get("fold_column")
        folds = None
        if as_training and handling == "kfold" and fold_col \
                and fold_col in frame:
            folds = frame.col(fold_col).to_numpy().astype(int)[:n]

        new_cols = []
        for col, m in self.enc_maps.items():
            if col not in frame:
                continue
            dom = m["domain"]
            codes = adapt_domain(frame.col(col), dom)[:n]
            c = np.clip(codes, 0, len(dom) - 1)
            prior = m["prior"]
            tot_sum = m["sum"].sum(axis=0)
            tot_cnt = m["cnt"].sum(axis=0)
            if folds is not None and m["sum"].shape[0] > 1:
                # fold j's encoding from every fold but j
                nf = m["sum"].shape[0]
                te_f = np.stack([
                    blend(tot_sum - m["sum"][j], tot_cnt - m["cnt"][j],
                          prior, k, f, blending) for j in range(nf)])
                enc = te_f[np.clip(folds, 0, nf - 1), c]
            elif as_training and handling == "loo":
                yv = self._resp_numeric(frame)[:n]
                enc = blend(tot_sum[c] - np.where(np.isnan(yv), 0.0, yv),
                            tot_cnt[c] - (~np.isnan(yv)).astype(float),
                            prior, k, f, blending)
            else:
                enc = blend(tot_sum, tot_cnt, prior, k, f, blending)[c]
            enc = np.where(codes < 0, prior, enc)   # NA / unseen → prior
            if as_training and noise > 0:
                enc = enc + rng.uniform(-noise, noise, size=enc.shape)
            new_cols.append((f"{col}_te", enc))

        arrays, domains = {}, {}
        for nm in frame.names:
            c = frame.col(nm)
            if c.is_categorical:
                arrays[nm], domains[nm] = _reinterned(c)
            else:
                arrays[nm] = c.to_numpy()
        arrays.update(new_cols)
        return Frame.from_numpy(arrays, domains=domains, device=frame.device)

    def _resp_numeric(self, frame: Frame) -> np.ndarray:
        c = frame.col(self.output["response"])
        if c.is_categorical:
            codes = adapt_domain(c, self.output["domain"])
            return np.where(codes < 0, np.nan, codes.astype(float))
        return c.to_numpy()

    def predict(self, frame: Frame) -> Frame:
        return self.transform(frame, as_training=False)

    def model_performance(self, frame: Frame, mask_weights=None):
        return None


class TargetEncoderEstimator(ModelBuilder):
    """h2o-py H2OTargetEncoderEstimator surface."""

    algo = "targetencoder"
    label = "TargetEncoder"
    cv_from_fold_column = False      # the fold column is leakage handling

    DEFAULTS = dict(
        blending=False, inflection_point=10.0, smoothing=20.0,
        data_leakage_handling="none", noise=0.01, seed=-1,
        fold_column=None, ignored_columns=None, nfolds=0,
        weights_column=None, fold_assignment="auto",
    )
    PORTED = frozenset(DEFAULTS)

    def __init__(self, **params):
        super().__init__(**params)
        if int(self.params.get("nfolds") or 0) >= 2:
            raise ValueError("TargetEncoder leakage control is "
                             "data_leakage_handling='kfold' + fold_column, "
                             "not generic CV (nfolds must be 0)")

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        n = frame.nrows
        rc = frame.col(y)
        yv = rc.to_numpy()           # codes of a categorical, NaN at NA
        if rc.is_categorical and rc.cardinality > 2:
            raise ValueError("TargetEncoder supports binomial or numeric "
                             "responses")
        w = (~np.isnan(yv)).astype(np.float64)
        yv = np.where(np.isnan(yv), 0.0, yv)

        handling = str(p.get("data_leakage_handling") or "none").lower()
        fold_col = p.get("fold_column")
        folds = None
        nfolds = 1
        if handling == "kfold":
            if not fold_col or fold_col not in frame:
                raise ValueError("kfold leakage handling requires fold_column")
            folds = frame.col(fold_col).to_numpy().astype(int)[:n]
            nfolds = int(folds.max()) + 1

        enc_cols = [c for c in x if frame.col(c).is_categorical]
        prior = float((yv * w).sum() / max(w.sum(), 1e-12))
        enc_maps = {}
        for col in enc_cols:
            c = frame.col(col)
            dom = c.domain or []
            host = c.host_view()
            cna = np.isnan(host)
            s, cnt = level_stats(np.where(cna, 0, host).astype(np.int64), yv,
                                 w * ~cna, max(len(dom), 1), frame.device,
                                 folds, nfolds)
            enc_maps[col] = {"sum": s, "cnt": cnt, "domain": list(dom),
                             "prior": prior}
        output = {"category": "TargetEncoder", "response": y,
                  "names": enc_cols, "domain": rc.domain, "prior": prior}
        return TargetEncoderModel(p, output, enc_maps)
