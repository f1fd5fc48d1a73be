"""DataInfo — the dense design matrix of a frame's predictors.

Reference: h2o3_tpu/frame/datainfo.py (hex/DataInfo.java). Categorical
columns expand to indicator columns (the first level dropped unless
``use_all_factor_levels``; an NA row is all zeros), numeric NAs take the
column's float32 rollup mean, and with ``standardize`` numerics become
(x - mean) / sigma (sigma 0 counts as 1). A scoring frame is adapted
through ``stats_override``: the training means, sigmas and domains, its
categorical codes mapped into the training domains (unseen levels NA).

The design is written in one pass into a preallocated float32
[Npad, P + 1] tensor on the frame's device, column block by column
block, with no concatenation of per-column pieces: at 11M rows x 28
columns a ``cat`` would hold the matrix twice. The trailing column of
ones (GLM's X1) is written in the same allocation. Padding rows
are NA in every column, so they hold the means (0 once standardized)
and zero indicators; GLM weighs them 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.rollups import rollup_mean_sigma


@dataclasses.dataclass
class DataInfo:
    names: List[str]                 # source columns
    coef_names: List[str]            # expanded coefficient names
    X1: torch.Tensor                 # [Npad, P + 1]: the design, ones
    is_cat: np.ndarray
    cat_offsets: np.ndarray          # start index of each cat block
    num_means: np.ndarray            # imputation means of numeric cols
    num_sigmas: np.ndarray
    domains: List[Optional[List[str]]]
    standardize: bool
    use_all_factor_levels: bool
    nrows: int

    @property
    def P(self) -> int:
        return len(self.coef_names)

    @property
    def X(self) -> torch.Tensor:
        """The [Npad, P] design without the ones column."""
        return self.X1[:, :self.P]


def _codes(col, dom, override: bool, frame: Frame):
    """(int64 codes, NA mask) on the frame's device; a scoring frame's
    codes are mapped into the training domain ``dom`` (unseen → NA)."""
    if not override:
        return col.data.long(), col.na_mask
    from h2o3_tpu_torch.models.model import adapt_domain
    codes = frame.local_rows(adapt_domain(col, dom), -1)
    t = torch.from_numpy(codes.astype(np.int64)).to(frame.device)
    return torch.clamp_min(t, 0), t < 0


def build_datainfo(frame: Frame, features: Sequence[str],
                   standardize: bool = True,
                   use_all_factor_levels: bool = False,
                   stats_override: Optional[dict] = None) -> DataInfo:
    """Expand ``features`` into the design matrix and a trailing column
    of ones (numeric NAs mean-imputed, the reference's only mode).

    ``stats_override`` carries the training-time means, sigmas and
    domains when adapting a scoring frame (adaptTestForTrain role)."""
    cols = [frame.col(n) for n in features]
    is_cat = np.array([c.is_categorical for c in cols], dtype=bool)
    first = 0 if use_all_factor_levels else 1
    coef_names: List[str] = []
    cat_offsets, num_means, num_sigmas = [], [], []
    domains: List[Optional[List[str]]] = []
    plan = []                         # (column, offset, kind, payload)
    for i, c in enumerate(cols):
        if is_cat[i]:
            dom = (stats_override["domains"][i] if stats_override is not None
                   else (c.domain or []))
            domains.append(dom)
            card = max(len(dom), 1)
            cat_offsets.append(len(coef_names))
            plan.append((c, len(coef_names), "cat", (dom, card)))
            coef_names += [f"{c.name}.{dom[lv]}" for lv in range(first, card)]
        else:
            domains.append(None)
            if stats_override is not None:
                mu = stats_override["num_means"][len(num_means)]
                sd = stats_override["num_sigmas"][len(num_sigmas)]
            else:
                mu, sd = rollup_mean_sigma(c)
                sd = sd or 1.0
            sd = sd if sd > 0 else 1.0
            num_means.append(mu)
            num_sigmas.append(sd)
            plan.append((c, len(coef_names), "num", (mu, sd)))
            coef_names.append(c.name)

    P = len(coef_names)
    dev = frame.device
    lo, hi = frame.span
    X1 = torch.empty((hi - lo, P + 1), dtype=torch.float32, device=dev)
    for c, off, kind, payload in plan:
        if kind == "cat":
            dom, card = payload
            k = card - first
            if k == 0:
                continue
            blk = X1[:, off:off + k]
            blk.zero_()
            code, na = _codes(c, dom, stats_override is not None, frame)
            on = ~na & (code >= first) & (code < card)
            blk.scatter_(1, torch.clamp(code - first, 0, k - 1)[:, None],
                         on.to(torch.float32)[:, None])
        else:
            mu, sd = (torch.tensor(np.float32(v), device=dev) for v in payload)
            x = c.data.to(torch.float32)
            x = torch.where(c.na_mask | torch.isnan(x), mu, x)
            X1[:, off] = (x - mu) / sd if standardize else x
    X1[:, P] = 1.0
    return DataInfo(
        names=list(features), coef_names=coef_names, X1=X1, is_cat=is_cat,
        cat_offsets=np.asarray(cat_offsets, np.int64),
        num_means=np.asarray(num_means), num_sigmas=np.asarray(num_sigmas),
        domains=domains, standardize=standardize,
        use_all_factor_levels=use_all_factor_levels, nrows=frame.nrows)


def stats_of(di: DataInfo) -> dict:
    """Training stats needed to rebuild the view on a scoring frame."""
    return {"num_means": di.num_means, "num_sigmas": di.num_sigmas,
            "domains": di.domains}


def coef_stats(di: DataInfo):
    """Per-coefficient (mean, sd) aligned with coef_names: (0, 1) for an
    indicator, the standardization stats for a numeric (GLM reports
    de-standardized coefficients with them)."""
    mus, sds = [], []
    ni = 0
    first = 0 if di.use_all_factor_levels else 1
    for i, cat in enumerate(di.is_cat):
        if cat:
            k = max(len(di.domains[i] or []), 1) - first
            mus += [0.0] * k
            sds += [1.0] * k
        else:
            mus.append(float(di.num_means[ni]))
            sds.append(float(di.num_sigmas[ni]))
            ni += 1
    return np.asarray(mus), np.asarray(sds)
