"""KMeans — Lloyd's iterations with Random, PlusPlus or Furthest init.

Reference: h2o3_tpu/models/kmeans.py (hex/kmeans/KMeans.java): the
design is ``frame/datainfo.py``'s (categoricals one-hot with all levels,
numerics mean-imputed and, by default, standardized). One Lloyd step is
the distance product d² = ‖x‖² − 2x·c + ‖c‖² (one float32 GEMM with TF32
held off), the argmin, and ONE ``segment_sum`` of [x·w, w, w·min d²] by
cluster, fixed point on the card, so a refit is bit-equal. An empty
cluster keeps its center. The loop stops when the total within-cluster
sum of squares falls by less than 1e-7 of itself (one host sync a step).

The inits pick rows on the host as the reference does: a
``RandomState`` seeded from ``draw_init_seeds`` (the port's own draw;
the reference draws that seed with ``jax.random``), the first center a
uniform valid row, then Random samples the rest without replacement,
PlusPlus samples ∝ d² and Furthest takes the row of largest weighted d².
``cluster_size_constraints`` runs the reference's greedy rebalance on the
host in float64 from one fetch of the design (sequential by nature; the
reference does the same). ``estimate_k`` sweeps k = 1.. and stops when a
k cuts the within sum of squares by less than 20%.

``max_runtime_secs`` is accepted and inert, as in the reference;
``user_points`` is a Frame or its DKV key. Not ported: KMeans on a
frame partitioned over a sharded mesh (A #12); MOJO export (A #10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.datainfo import DataInfo, build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame, resolve_frame
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         masked_weights)
from h2o3_tpu_torch.ops.gram import exact_f32
from h2o3_tpu_torch.ops.segments import segment_sum
from h2o3_tpu_torch.parallel.device import fetch

DEFAULT_SEED = 0x63A7       # the reference's seed when ``seed`` < 0
STOP_REL = 1e-7             # Lloyd's stops below this relative fall


def draw_init_seeds(seed: int, runs: Optional[int]) -> List[int]:
    """The seeds of the inits' host ``RandomState``: one for a fit
    (``runs`` None), one for each k = 1..``runs`` of ``estimate_k``'s
    sweep. Drawn from ``RandomState(seed)``; kept apart from their use
    so a test can feed in the reference's ``jax.random`` draws."""
    r = np.random.RandomState(seed & 0xFFFFFFFF)
    return [int(v) for v in r.randint(0, 2 ** 31 - 1, size=runs or 1)]


def dist2(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N, K] squared distances by the product d² = ‖x‖² − 2x·c + ‖c‖²,
    clamped at 0."""
    with exact_f32():
        xc = X @ centers.T
    c2 = (centers * centers).sum(1)
    x2 = (X * X).sum(1, keepdim=True)
    return torch.clamp_min(x2 - 2.0 * xc + c2[None, :], 0.0)


def lloyd_step(X, w, centers, k: int):
    """One Lloyd's iteration: (new centers, assignment, weight a
    cluster, within sum of squares a cluster)."""
    d2 = dist2(X, centers)
    assign = torch.argmin(d2, dim=1)
    mind2 = d2.gather(1, assign[:, None])[:, 0]
    vals = torch.cat([X * w[:, None], w[:, None], (w * mind2)[:, None]], 1)
    sums = segment_sum(assign, vals, n_nodes=k)
    counts, withinss = sums[:, -2], sums[:, -1]
    new = torch.where(counts[:, None] > 0,
                      sums[:, :-2] / torch.clamp_min(counts[:, None], 1e-12),
                      centers)          # an empty cluster keeps its center
    return new, assign, counts, withinss


def init_centers(X, w, k: int, method: str, rng_seed: int):
    """(initial centers [k, P], their rows): the first a uniform valid
    row, then Random (the rest without replacement), Furthest (the row
    of largest weighted distance to the centers so far) or PlusPlus
    (sampled with probability ∝ that float32 distance), as the
    reference picks them."""
    n = X.shape[0]
    wn = fetch(w)
    valid = np.flatnonzero(wn > 0)
    rng = np.random.RandomState(rng_seed)
    rows = [int(valid[rng.randint(len(valid))])]
    if method == "random":
        rows += [int(i) for i in rng.choice(valid, size=k - 1,
                                            replace=False)]
        return X[rows].clone(), rows
    for _ in range(k - 1):
        md = dist2(X, X[rows]).min(dim=1).values
        if method == "furthest":
            rows.append(int(torch.argmax(md * w)))
            continue
        d2 = fetch(md) * wn
        p = d2 / max(d2.sum(), 1e-12)
        rows.append(int(rng.choice(n, p=p)))
    return X[rows].clone(), rows


def run_lloyds(X, w, k: int, init: str, rng_seed: int, iters: int):
    """Lloyd's from ``init`` until the within sum of squares stops
    falling or ``iters`` steps: (centers, assignment, counts, withinss,
    steps)."""
    centers = init_centers(X, w, k, init, rng_seed)[0]
    assign = counts = withinss = None
    prev = np.inf
    it = 0
    for it in range(1, iters + 1):
        centers, assign, counts, withinss = lloyd_step(X, w, centers, k)
        tw = float(withinss.sum())
        if prev - tw < STOP_REL * max(abs(prev), 1.0):
            break
        prev = tw
    return centers, assign, counts, withinss, it


def run_lloyds_constrained(X, w, k: int, iters: int, mins: List[int],
                           centers):
    """Lloyd's with a minimum size a cluster: each step assigns by
    distance, then fills each cluster under its minimum with the rows of
    least distance margin from clusters that stay above theirs. Host
    float64 from ONE fetch of the design, as the reference runs it."""
    wn = fetch(w)
    valid = wn > 0
    if sum(mins) > int(valid.sum()):
        raise ValueError(
            f"The sum of cluster_size_constraints ({sum(mins)}) exceeds "
            f"the number of training rows ({int(valid.sum())}).")
    Xh = fetch(X).astype(np.float64)
    ch = fetch(centers).astype(np.float64)
    assign = np.where(valid, 0, -1).astype(np.int64)
    for _ in range(max(iters, 1)):
        d2 = ((Xh[:, None, :] - ch[None, :, :]) ** 2).sum(axis=2)
        assign = d2.argmin(axis=1)
        assign[~valid] = -1
        for c in range(k):
            deficit = mins[c] - int((assign == c).sum())
            if deficit <= 0:
                continue
            margin = d2[:, c] - d2[np.arange(len(assign)),
                                   np.maximum(assign, 0)]
            margin[~valid | (assign == c)] = np.inf
            for r in np.argsort(margin):
                if deficit <= 0 or not np.isfinite(margin[r]):
                    break
                src = assign[r]
                if src >= 0 and (assign == src).sum() <= mins[src]:
                    continue
                assign[r] = c
                deficit -= 1
        for c in range(k):
            sel = assign == c
            tot = wn[sel].sum()
            if tot > 0:
                ch[c] = (Xh[sel] * wn[sel, None]).sum(axis=0) / tot
    d2 = ((Xh[:, None, :] - ch[None, :, :]) ** 2).sum(axis=2)
    wss = np.zeros(k)
    counts = np.zeros(k, np.float32)
    for c in range(k):
        sel = assign == c
        wss[c] = float((d2[sel, c] * wn[sel]).sum())
        counts[c] = wn[sel].sum()
    dev = X.device
    return (torch.from_numpy(ch.astype(np.float32)).to(dev),
            torch.from_numpy(np.maximum(assign, 0)).to(dev),
            torch.from_numpy(counts).to(dev),
            torch.from_numpy(wss.astype(np.float32)).to(dev))


def clustering_metrics(X, w, counts, withinss) -> ModelMetrics:
    """ModelMetricsClustering: totss, tot_withinss, betweenss and the
    centroid statistics."""
    zero = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    gsum = segment_sum(zero, torch.cat([X * w[:, None], w[:, None]], 1),
                       n_nodes=1)[0]
    tot_w = float(gsum[-1])
    gmean = gsum[:-1] / max(tot_w, 1e-12)
    totss = float((w * ((X - gmean[None, :]) ** 2).sum(1)).sum())
    tot_within = float(withinss.sum())
    return ModelMetrics(
        "Clustering", int(tot_w), tot_within / max(tot_w, 1e-12),
        totss=totss, tot_withinss=tot_within, betweenss=totss - tot_within,
        centroid_stats={"size": fetch(counts).tolist(),
                        "within_cluster_sum_of_squares":
                            fetch(withinss).tolist()})


def _row_weights(frame: Frame, wc: Optional[str]) -> torch.Tensor:
    """Valid rows times the weights column (NA weighs 0)."""
    w = frame.valid_weights()
    if wc and wc in frame:
        v = frame.col(wc).numeric_view()
        w = w * torch.where(torch.isnan(v), 0.0, v)
    return w


class KMeansModel(Model):
    algo = "kmeans"

    def __init__(self, params, output, centers_std, di_stats, features,
                 standardize: bool):
        super().__init__(params, output)
        self.centers_std = centers_std     # [k, P], the design's space
        self.di_stats = di_stats
        self.features = features
        self.standardize = standardize

    def _design(self, frame: Frame) -> DataInfo:
        return build_datainfo(frame, self.features,
                              standardize=self.standardize,
                              use_all_factor_levels=True,
                              stats_override=self.di_stats)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        X = self._design(frame).X
        d2 = dist2(X, self.centers_std.to(X.device))
        return {"predict": fetch(torch.argmin(d2, dim=1))[:frame.nrows]
                .astype(np.int32)}

    def model_performance(self, frame: Frame, mask_weights=None):
        """Clustering metrics of ``frame``'s rows (its weights column, if
        it has the training one, weighs them)."""
        X = self._design(frame).X
        w = masked_weights(_row_weights(frame,
                                        self.params.get("weights_column")),
                           mask_weights)
        k = self.centers_std.shape[0]
        _, _, counts, withinss = lloyd_step(X, w,
                                            self.centers_std.to(X.device), k)
        return clustering_metrics(X, w, counts, withinss)


class KMeansEstimator(ModelBuilder):
    """h2o-py H2OKMeansEstimator surface. ``max_runtime_secs`` is
    accepted and inert, as in the reference."""

    algo = "kmeans"
    label = "KMeans"

    DEFAULTS = dict(
        k=1, max_iterations=10, init="Furthest", standardize=True,
        seed=-1, estimate_k=False, max_runtime_secs=0,
        cluster_size_constraints=None, user_points=None,
        ignored_columns=None, nfolds=0, fold_column=None, weights_column=None,
        fold_assignment="auto",
    )
    PORTED = frozenset(DEFAULTS)

    def _mins(self, k: int) -> Optional[List[int]]:
        cons = self.params.get("cluster_size_constraints")
        if cons is None:
            return None
        mins = [int(v) for v in cons]
        if len(mins) != k:
            raise ValueError(
                f"cluster_size_constraints must have k={k} entries")
        return mins

    def _user_centers(self, frame: Frame, x: List[str], di: DataInfo):
        """``user_points`` (a Frame, one column a predictor, matched by
        position) through the training design: [k, P] on the design's
        device."""
        up = self.params["user_points"]
        if isinstance(up, str):
            up = up.strip('"')
        up = resolve_frame(up, "user_points")
        if len(up.names) != len(x):
            raise ValueError(
                f"user_points must have one column per predictor "
                f"({len(x)}), got {len(up.names)}")
        cols = [dataclasses.replace(up.col(a), name=b)
                for a, b in zip(up.names, x)]
        for c in cols:
            if frame.col(c.name).is_categorical != c.is_categorical:
                kind = ("categorical" if frame.col(c.name).is_categorical
                        else "numeric")
                raise ValueError(f"user_points column for {kind} predictor "
                                 f"'{c.name}' must be {kind} too")
        upf = Frame(cols, up.nrows, up.device, npad=up.nrows_padded,
                    block=up.block)
        udi = build_datainfo(upf, x, standardize=bool(
            self.params["standardize"]), use_all_factor_levels=True,
            stats_override=stats_of(di))
        return udi.X[:up.nrows].to(di.X.device)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        x = list(x)
        di = build_datainfo(frame, x, standardize=bool(p["standardize"]),
                            use_all_factor_levels=True)
        X = di.X
        w = _row_weights(frame, p.get("weights_column"))
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else DEFAULT_SEED
        init = str(p["init"]).lower()
        iters = int(p["max_iterations"])
        k = int(p["k"])

        if p.get("user_points") is not None:
            centers = self._user_centers(frame, x, di)
            k = centers.shape[0]
            mins = self._mins(k)
            if mins is not None:
                fit = run_lloyds_constrained(X, w, k, iters, mins, centers)
            else:
                for _ in range(max(iters, 1)):
                    fit = lloyd_step(X, w, centers, k)
                    centers = fit[0]
            return self._finish_model(frame, x, di, w, fit, k,
                                      max(iters, 1), validation_frame)
        mins = self._mins(k)
        if mins is not None:
            if p["estimate_k"]:
                raise ValueError("Cannot estimate k if "
                                 "cluster_size_constraints are provided.")
            rs = draw_init_seeds(seed, None)[0]
            centers = init_centers(X, w, k, init, rs)[0]
            fit = run_lloyds_constrained(X, w, k, iters, mins, centers)
            steps = iters
        elif p["estimate_k"]:
            # greedy sweep: stop when a k cuts the within SS by < 20%
            best = prev_tw = None
            for kk, rs in enumerate(draw_init_seeds(seed, k), start=1):
                cand = run_lloyds(X, w, kk, init, rs, iters)
                tw = float(cand[3].sum())
                if prev_tw is not None and tw > 0.8 * prev_tw:
                    break
                best, prev_tw, k_used = cand, tw, kk
            fit, steps, k = best[:4], best[4], k_used
        else:
            *fit, steps = run_lloyds(X, w, k, init,
                                     draw_init_seeds(seed, None)[0], iters)
        return self._finish_model(frame, x, di, w, fit, k, steps,
                                  validation_frame)

    def _finish_model(self, frame, x, di, w, fit, k, steps,
                      validation_frame):
        centers, _, counts, withinss = fit
        cstd = fetch(centers)
        c_out = cstd.copy()         # de-standardized numeric centers
        ptr = num_j = 0
        for i, is_c in enumerate(di.is_cat):
            if is_c:
                ptr += len(di.domains[i] or [])   # the all-levels block
                continue
            if self.params["standardize"]:
                c_out[:, ptr] = (cstd[:, ptr] * di.num_sigmas[num_j]
                                 + di.num_means[num_j])
            num_j += 1
            ptr += 1
        output = {"category": ModelCategory.CLUSTERING, "response": None,
                  "names": list(x), "domain": None, "k": k,
                  "centers": c_out.tolist(), "centers_std": cstd.tolist(),
                  "coef_names": di.coef_names, "iterations": steps}
        model = KMeansModel(self.params, output, centers, stats_of(di),
                            list(x), bool(self.params["standardize"]))
        model.training_metrics = clustering_metrics(di.X, w, counts,
                                                    withinss)
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        return model
