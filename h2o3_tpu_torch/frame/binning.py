"""Feature binning for histogram tree algorithms.

Reference: h2o3_tpu/frame/binning.py. Binning runs ONCE up front into an
int8/int32 [N, F] device matrix, so every tree level is integer work.

A partitioned frame (``Frame.from_numpy_partitioned``) takes its edges
from the full host views, so every rank gets the same edges, and bins
only its own rows on its device.

Layout per feature f with ``nb[f]`` real bins: bin ids 0..nb[f]-1 hold
values, bin id B-1 (shared max) holds NAs; unused ids between are empty
and never win a split because their counts are zero.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame


def _bin_device(datas, nas, remaps, edges: torch.Tensor, *, B: int,
                is_cat: Sequence[bool], div: Sequence[int]) -> torch.Tensor:
    """All columns → one [Npad, F] bin matrix: numeric bin = #edges <= x
    (``searchsorted(right=True)`` over the +inf-padded edge row),
    categorical bin = code // div, NA → B-1; int8 when B <= 127."""
    cols = []
    for i, cat in enumerate(is_cat):
        na = nas[i]
        if cat:
            code = datas[i].to(torch.int32)
            if remaps[i] is not None:
                lut = remaps[i]
                code = lut[code.clamp(0, lut.shape[0] - 1).long()]
                na = na | (code < 0)
                code = code.clamp_min(0)
            # cardinality beyond nbins_cats: ADJACENT codes group into one
            # bin (integer divide), never a modulo alias
            b = torch.div(code, div[i], rounding_mode="floor") \
                if div[i] > 1 else code
        else:
            x = torch.where(na, torch.nan, datas[i].to(torch.float32))
            b = torch.searchsorted(edges[i].contiguous(), x, right=True)
        cols.append(torch.where(na, B - 1, b.to(torch.int32)))
    out = torch.stack(cols, dim=1)
    # int8 when the bin ids fit: 4x less memory for the largest resident
    # of tree training
    return out.to(torch.int8 if B <= 127 else torch.int32)


@dataclasses.dataclass
class BinnedMatrix:
    """Device-resident binned design matrix for tree building/scoring."""
    bins: torch.Tensor         # [Npad, F] int8/int32; NA = nbins_total-1
    nbins: torch.Tensor        # [F] int32 real bins per feature (excl. NA)
    edges: torch.Tensor        # [F, E] float32 split thresholds, +inf padded
    is_cat: np.ndarray         # [F] bool (host)
    names: List[str]
    nbins_total: int           # B = max real bins + 1 (NA)
    nrows: int
    domains: List[Optional[List[str]]]
    nbins_cats: int = 64       # cat-bin cap used at train time
    source_ref: Optional[object] = None  # weakref to the built-from frame


def _numeric_edges(x: np.ndarray, nbins: int,
                   method: str = "quantiles",
                   w: Optional[np.ndarray] = None) -> np.ndarray:
    """Bin edges over valid values. method='quantiles' is the
    QuantilesGlobal histogram type (hex/tree/SharedTree; default hist
    behavior of the reference's XGBoost extension); 'uniform' is the
    equal-width UniformAdaptive type (hex/tree/DHistogram.java min/maxEx
    range binning) — required by IsolationForest, whose random thresholds
    must be uniform over the VALUE range, not the rank space.

    Quantile edges come from the WEIGHTED cdf over distinct values, with
    each cut placed at the midpoint between adjacent distinct values.
    This makes binning exactly invariant under the reference's row-weight
    contract (pyunit_weights_gbm): weight=k ≡ k duplicated rows, weight=0
    ≡ row removed, uniform weights ≡ no weights — properties plain
    np.quantile over raw rows does NOT have (zero-weight rows would shift
    edges). Midpoint cuts also never coincide with a data value, so a
    row's bin is insensitive to float rounding of the edge itself."""
    finite = np.isfinite(x)
    v = x[finite]
    wv = None
    if w is not None:
        wv = np.asarray(w, dtype=np.float64)[finite]
        pos = wv > 0
        v, wv = v[pos], wv[pos]
    if v.size == 0:
        return np.zeros((0,), dtype=np.float32)
    if method == "uniform":
        lo, hi = float(v.min()), float(v.max())
        if hi <= lo:
            return np.zeros((0,), dtype=np.float32)
        return np.linspace(lo, hi, nbins + 1)[1:-1].astype(np.float32)
    if method == "random":
        # XRT (extremely randomized trees): random split thresholds over
        # the value range (DRFStepsProvider XRT / DHistogram Random type)
        lo, hi = float(v.min()), float(v.max())
        if hi <= lo:
            return np.zeros((0,), dtype=np.float32)
        rng = np.random.RandomState(abs(hash((lo, hi))) % (2**31))
        return np.sort(rng.uniform(lo, hi, nbins - 1)).astype(np.float32)
    if v.size > 200_000:  # sketch on a sample, like the reference's ExactQuantilesToUse cap
        rng = np.random.RandomState(0xC0FFEE)
        idx = rng.randint(0, v.size, 200_000)
        v = v[idx]
        wv = None if wv is None else wv[idx]
    u, inv = np.unique(v, return_inverse=True)
    if u.size < 2:
        return np.zeros((0,), dtype=np.float32)
    wu = np.bincount(inv, weights=wv, minlength=u.size) if wv is not None \
        else np.bincount(inv, minlength=u.size).astype(np.float64)
    cdf = np.cumsum(wu)
    cdf /= cdf[-1]
    qs = np.linspace(0.0, 1.0, nbins + 1)[1:-1]
    # first distinct value whose cumulative weight reaches q; cut after it
    idx = np.searchsorted(cdf, qs, side="left")
    idx = idx[idx < u.size - 1]
    mids = (u[idx].astype(np.float64) + u[idx + 1]) * 0.5
    return np.unique(mids.astype(np.float32))


def bin_frame(frame: Frame, features: Sequence[str], nbins: int = 64,
              nbins_cats: int = 64,
              edges_override: Optional[List[np.ndarray]] = None,
              nbins_total_override: Optional[int] = None,
              train_domains: Optional[List[Optional[List[str]]]] = None,
              histogram_type: str = "quantiles",
              weights: Optional[np.ndarray] = None) -> BinnedMatrix:
    """Bin ``features`` of ``frame`` into a device int matrix on the
    frame's device.

    ``edges_override``/``train_domains`` re-bin a scoring frame with
    training-time edges and categorical domains (unseen test levels map
    to the NA bin). ``histogram_type`` is ``_numeric_edges``'s method
    (``quantiles``, ``uniform`` or ``random``; any other spelling takes
    the quantile branch). ``weights`` (host [nrows]) makes the quantile
    sketch weighted so the row-weight ≡ row-multiplicity contract holds.
    The port keeps no cache of binned matrices (the reference's is keyed
    by ``histogram_type`` too); a CV fit shares its main model's.
    """
    F = len(features)
    names = list(features)
    cols = [frame.col(n) for n in names]
    is_cat = np.array([c.is_categorical for c in cols], dtype=bool)
    domains = [c.domain for c in cols]

    edge_list: List[np.ndarray] = []
    nb = np.zeros((F,), dtype=np.int32)
    div = np.ones((F,), dtype=np.int32)   # code→bin divisor (card>nbins_cats)
    for i, c in enumerate(cols):
        if is_cat[i]:
            if train_domains is not None and train_domains[i] is not None:
                card = max(len(train_domains[i]), 1)
            else:
                card = max(c.cardinality, 1)
            if card > nbins_cats:
                div[i] = -(-card // nbins_cats)   # ceil
                nb[i] = -(-card // div[i])
            else:
                nb[i] = card
            edge_list.append(np.zeros((0,), dtype=np.float32))
        else:
            if edges_override is not None:
                e = edges_override[i]
            else:
                e = _numeric_edges(c.host_view(), nbins, histogram_type,
                                   w=weights)
            nb[i] = len(e) + 1
            edge_list.append(e)

    # B depends only on the binning CONFIG, never the data (unused bin ids
    # have zero counts and never win a split)
    B = max(int(nbins), int(nb.max()) if F else 1) + 1  # +1 shared NA bin
    if nbins_total_override is not None:
        B = nbins_total_override
    emax = max(nbins - 1, max((len(e) for e in edge_list), default=0))
    edges = np.full((F, max(emax, 1)), np.inf, dtype=np.float32)
    for i, e in enumerate(edge_list):
        edges[i, : len(e)] = e

    device = frame.device
    edges_dev = torch.from_numpy(edges).to(device)
    remaps = []
    for i, c in enumerate(cols):
        if is_cat[i] and train_domains is not None \
                and train_domains[i] is not None \
                and c.domain != train_domains[i]:
            lut = {lvl: j for j, lvl in enumerate(train_domains[i])}
            mapping = np.array([lut.get(lvl, -1)
                                for lvl in (c.domain or [])], np.int32)
            if len(mapping) == 0:
                mapping = np.array([-1], dtype=np.int32)
            remaps.append(torch.from_numpy(mapping).to(device))
        else:
            remaps.append(None)
    if F:
        bins = _bin_device([c.data for c in cols],
                           [c.na_mask for c in cols], remaps, edges_dev,
                           B=B, is_cat=[bool(v) for v in is_cat],
                           div=[int(v) for v in div])
    else:
        lo, hi = frame.span
        bins = torch.zeros((hi - lo, 0), dtype=torch.int32, device=device)
    return BinnedMatrix(bins=bins, nbins=torch.from_numpy(nb).to(device),
                        edges=edges_dev, is_cat=is_cat, names=names,
                        nbins_total=B, nrows=frame.nrows, domains=domains,
                        nbins_cats=nbins_cats,
                        source_ref=weakref.ref(frame))


def rebin_for_scoring(train_bm: BinnedMatrix, frame: Frame) -> BinnedMatrix:
    """Bin a new frame with the training matrix's edges/domains; the
    frame the matrix was built from returns the matrix itself."""
    ref = train_bm.source_ref
    if ref is not None and ref() is frame:
        return train_bm
    host_edges = train_bm.edges.cpu().numpy()
    per_feat = [e[np.isfinite(e)] for e in host_edges]
    return bin_frame(frame, train_bm.names,
                     nbins=train_bm.nbins_total - 1,
                     nbins_cats=train_bm.nbins_cats,
                     edges_override=per_feat,
                     nbins_total_override=train_bm.nbins_total,
                     train_domains=train_bm.domains)
