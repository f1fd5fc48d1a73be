"""Grid search — Cartesian and RandomDiscrete hyperparameter walks.

Reference: h2o3_tpu/ml/grid.py (hex/grid/GridSearch.java:70 with the
HyperSpaceWalker strategies and the Grid key'd model collection). The
walk trains one combo after another: ``max_models`` counts successful
models, ``max_runtime_secs`` bounds the walk, ``stopping_rounds`` stops
it on the ScoreKeeper's windowed averages of the sort metric, and a
combo that fails is recorded in ``Grid.failures`` with its error.
RandomDiscrete shuffles the combos with ``np.random.RandomState(seed)``
as the reference does, so both walk the same order.

Model batching (``_train_batched``, ``parallel/model_batch.py``): before
the walk, the shape buckets of two combos or more among the first
``max_models`` train together (GBM through the model-axis level
kernels, GLM as batched IRLS), unless ``H2O3TPU_BATCH_MODELS=off``. The
walk then takes those models in walk order where it would have trained
them, so the budgets, asymptotic stopping and the leaderboard behave as
in the sequential walk, and the models it never reaches are removed from
the DKV. A bucket its trainer cannot batch (``BatchIneligible``: CV,
checkpoints, runtime caps, ...) walks sequentially.

Not ported: the cluster scheduler's fan-out (``_train_scheduled``, A
#12/#13), and ``recovery_dir`` snapshots with ``resume_grid`` (A #13).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.parallel import model_batch

log = logging.getLogger("h2o3_tpu_torch.grid")

# lower-is-better metrics (hex/ModelMetrics sort contract)
_ASC = {"logloss", "rmse", "mse", "mae", "mean_per_class_error",
        "mean_residual_deviance", "error_rate", "rmsle"}


def stop_early_windowed(scores: List[float], k: int, tol: float,
                        less_is_better: bool) -> bool:
    """ScoreKeeper.stopEarly (hex/ScoreKeeper.java:278): k+1 moving
    averages of window k over the last 2k scores (the first score is
    not counted toward the length), converged when the best new window
    does not improve on the reference window by the relative
    tolerance."""
    if k <= 0 or len(scores) - 1 < 2 * k:
        return False
    mov = []
    for i in range(k + 1):
        start = len(scores) - 2 * k + i
        m = float(np.mean(scores[start:start + k]))
        if np.isnan(m):
            return False
        mov.append(m)
    last_before, rest = mov[0], mov[1:]
    mn, mx = min(rest), max(rest)
    if less_is_better and last_before == 0.0:
        return True                    # converged to the lower bound
    if np.sign(max(mov)) != np.sign(min(mov)):
        return False                   # a zero crossing: not converged
    extreme = mn if less_is_better else mx
    if np.sign(extreme) != np.sign(last_before):
        return False
    ratio = extreme / last_before
    if np.isnan(ratio):
        return False
    return (ratio >= 1 - tol) if less_is_better else (ratio <= 1 + tol)


def sort_value(model, metric: str):
    """The model's value of ``metric`` in its default metrics (None when
    it has none)."""
    mmx = model.default_metrics
    d = mmx.to_dict() if hasattr(mmx, "to_dict") else dict(mmx or {})
    aliases = {"auc": "AUC", "gini": "Gini", "rmse": "RMSE", "mse": "MSE",
               "f1": "max_f1", "aucpr": "pr_auc", "residual_deviance":
               "mean_residual_deviance"}
    key = aliases.get(metric.lower(), metric)
    if key not in d and metric in d:
        key = metric
    return d.get(key)


def default_sort_metric(model) -> str:
    cat = model.output.get("category")
    if cat == "Binomial":
        return "auc"
    if cat == "Multinomial":
        return "mean_per_class_error"
    return "mean_residual_deviance"


class Grid:
    """A trained grid (hex/grid/Grid.java), stored under ``grid_id``."""

    def __init__(self, grid_id: str, models: List, failures: List[dict],
                 sort_metric: str):
        self.grid_id = grid_id
        self.models = models
        self.failures = failures
        self.sort_metric = sort_metric
        DKV.put(grid_id, self)

    @property
    def model_ids(self) -> List[str]:
        return [m.key for m in self.models]

    def sorted_models(self, metric: Optional[str] = None,
                      decreasing: Optional[bool] = None) -> List:
        metric = metric or self.sort_metric
        vals = [(sort_value(m, metric), m) for m in self.models]
        vals = [(v, m) for v, m in vals if v is not None]
        if not vals and self.models:
            # an unknown sort metric keeps the models in walk order
            return list(self.models)
        if decreasing is None:
            decreasing = metric.lower() not in _ASC
        return [m for _, m in sorted(vals, key=lambda t: t[0],
                                     reverse=decreasing)]

    def summary_table(self, metric: Optional[str] = None) -> List[dict]:
        metric = metric or self.sort_metric
        return [{"model_id": m.key, metric: sort_value(m, metric)}
                for m in self.sorted_models(metric)]


class GridSearch:
    """The hex/grid/GridSearch.java driver.

    ``strategy`` 'Cartesian' walks the whole cross product;
    'RandomDiscrete' walks it in a seeded random order under the
    ``max_models`` / ``max_runtime_secs`` budgets."""

    def __init__(self, builder_cls, hyper_params: Dict[str, Sequence],
                 search_criteria: Optional[dict] = None, grid_id: str = None,
                 recovery_dir: Optional[str] = None, **fixed_params):
        if recovery_dir:
            raise NotImplementedError(
                "GridSearch recovery_dir is not ported yet: its snapshots "
                "and resume_grid wait for core/recovery.py (ROADMAP A #13)")
        self.builder_cls = builder_cls

        def _dedup(vals):
            # repeated hyper values count once (HyperSpaceWalker)
            seen, out = set(), []
            for v in vals:
                kv = tuple(v) if isinstance(v, list) else v
                if kv not in seen:
                    seen.add(kv)
                    out.append(v)
            return out
        self.hyper_params = {k: _dedup(list(v))
                             for k, v in hyper_params.items()}
        self.criteria = dict(search_criteria or {"strategy": "Cartesian"})
        self.fixed = fixed_params
        self.grid_id = grid_id or make_key(f"grid_{builder_cls.algo}")

    def _combos(self) -> List[dict]:
        names = sorted(self.hyper_params)
        all_combos = [dict(zip(names, vals)) for vals in itertools.product(
            *(self.hyper_params[n] for n in names))]
        strat = str(self.criteria.get("strategy", "Cartesian")).lower()
        if strat == "randomdiscrete":
            seed = int(self.criteria.get("seed", -1))
            rng = np.random.RandomState(seed if seed >= 0 else None)
            rng.shuffle(all_combos)
        return all_combos

    def train(self, training_frame, y: Optional[str] = None,
              x: Optional[Sequence[str]] = None,
              validation_frame=None) -> Grid:
        combos = self._combos()
        budget_s = float(self.criteria.get("max_runtime_secs", 0) or 0)
        max_models = int(self.criteria.get("max_models", 0) or 0)
        stop_rounds = int(self.criteria.get("stopping_rounds", 0) or 0)
        stop_tol = float(self.criteria.get("stopping_tolerance", 1e-3)
                         or 1e-3)
        stop_scores: List[float] = []
        t0 = time.time()
        models: List = []
        failures: List[dict] = []
        job = Job(f"grid {self.builder_cls.algo}", work=float(len(combos)),
                  device=training_frame.device)
        job.status = "RUNNING"
        pre = self._train_batched(combos, training_frame, y, x,
                                  validation_frame, job, budget_s=budget_s,
                                  t0=t0, max_models=max_models)
        for i, combo in enumerate(combos):
            if budget_s and time.time() - t0 > budget_s:
                log.info("grid budget exhausted after %d models",
                         len(models))
                break
            if max_models and len(models) >= max_models:
                break
            params = {**self.fixed, **combo}
            try:
                m = pre.pop(i, None)
                if m is None:
                    m = self.builder_cls(**params).train(
                        training_frame, y=y, x=x,
                        validation_frame=validation_frame)
                m.output["grid_params"] = combo
                models.append(m)
                if stop_rounds > 0:
                    # asymptotic stopping over the walk's metric history
                    sm = (self.criteria.get("sort_metric")
                          or default_sort_metric(m))
                    v = sort_value(m, sm)
                    if v is not None:
                        stop_scores.append(float(v))
                        if stop_early_windowed(stop_scores, stop_rounds,
                                               stop_tol, sm.lower() in _ASC):
                            log.info("grid stopping criteria met after %d "
                                     "models", len(models))
                            break
            except Exception as e:   # noqa: BLE001 - failed combos recorded
                log.warning("grid combo %s failed: %s", combo, e)
                failures.append({"params": combo, "error": str(e)})
            job.update(1.0, f"model {i + 1}/{len(combos)}")
        # batched models the walk never reached (a budget or stopping
        # fired first): the sequential walk would not have trained them
        for m in pre.values():
            DKV.remove(m.key)
        job.status = "DONE"
        sort_metric = (self.criteria.get("sort_metric")
                       or (default_sort_metric(models[0]) if models
                           else "mse"))
        return Grid(self.grid_id, models, failures, sort_metric)

    def _train_batched(self, combos: List[dict], training_frame, y, x,
                       validation_frame, job, *, budget_s: float,
                       t0: float, max_models: int) -> Dict[int, object]:
        """Train the eligible shape buckets ahead of the walk; returns
        {combo index: Model}, each stored in the DKV. Only the first
        ``max_models`` combos are planned (the walk can take no more
        successes), a bucket of one combo is left to the walk, and no
        bucket starts once the walk's budget is spent.

        Only ``BatchIneligible`` sends a bucket back to the walk. The
        reference also falls back on any other error; here that error
        raises, since a model-axis kernel that fails to build or launch
        must show rather than hide behind the sequential walk."""
        pre: Dict[int, object] = {}
        if not model_batch.enabled() or len(combos) < 2:
            return pre
        planned = combos[:max_models] if max_models else combos
        algo = self.builder_cls.algo
        for bucket in model_batch.plan_buckets(algo, planned):
            if bucket.width < 2:
                continue
            if budget_s and time.time() - t0 > budget_s:
                break
            try:
                models = model_batch.train_bucket(
                    self.builder_cls, self.fixed,
                    [planned[i] for i in bucket.indices], training_frame,
                    y=y, x=x, validation_frame=validation_frame)
            except model_batch.BatchIneligible as e:
                log.debug("grid bucket not batchable (%s): sequential", e)
                continue
            for i, m in zip(bucket.indices, models):
                m._store(make_key(f"model_{algo}"))
                pre[i] = m
            job.update(0.0, "batched buckets")
        return pre


def resume_grid(recovery_dir: str, training_frame, validation_frame=None):
    """Resume an interrupted grid from its recovery snapshots: not ported
    (ROADMAP A #13)."""
    raise NotImplementedError(
        "resume_grid is not ported yet: grid snapshots wait for "
        "core/recovery.py (ROADMAP A #13)")
