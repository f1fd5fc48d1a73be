"""Leaderboard — a metric-ranked model registry.

Reference: h2o3_tpu/ml/leaderboard.py (hex/leaderboard/Leaderboard.java):
models ordered by their category's default metric (AUC descending for
binomial, mean per-class error ascending for multinomial, mean residual
deviance ascending for regression), on cross-validation metrics where a
model has them (``Model.default_metrics``), with extra metric columns a
row.
"""

from __future__ import annotations

from typing import List, Optional

from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.ml.grid import _ASC, default_sort_metric, sort_value

_EXTRA_COLS = {
    "Binomial": ["auc", "logloss", "pr_auc", "mean_per_class_error", "rmse",
                 "mse"],
    "Multinomial": ["mean_per_class_error", "logloss", "rmse", "mse"],
    "Regression": ["mean_residual_deviance", "rmse", "mse", "mae", "rmsle"],
}


class Leaderboard:
    def __init__(self, project_name: str = "default",
                 sort_metric: Optional[str] = None):
        self.key = make_key(f"leaderboard_{project_name}")
        self.project_name = project_name
        self.sort_metric = sort_metric
        self.models: List = []
        DKV.put(self.key, self)

    def add(self, *models):
        for m in models:
            if m is not None and m.key not in {x.key for x in self.models}:
                self.models.append(m)

    def _metric(self) -> str:
        if self.sort_metric:
            return self.sort_metric
        if not self.models:
            return "mse"
        return default_sort_metric(self.models[0])

    def sorted_models(self) -> List:
        """The models with a value of the sort metric, best first (a
        stable sort: ties keep the order the models were added in)."""
        metric = self._metric()
        rows = [(sort_value(m, metric), m) for m in self.models]
        rows = [(v, m) for v, m in rows if v is not None]
        reverse = metric.lower() not in _ASC
        return [m for _, m in sorted(rows, key=lambda t: t[0],
                                     reverse=reverse)]

    @property
    def leader(self):
        s = self.sorted_models()
        return s[0] if s else None

    def as_table(self) -> List[dict]:
        """The leaderboard's rows (the AutoML leaderboard frame)."""
        if not self.models:
            return []
        cat = self.models[0].output.get("category")
        cols = _EXTRA_COLS.get(cat, _EXTRA_COLS["Regression"])
        out = []
        for m in self.sorted_models():
            row = {"model_id": m.key}
            for c in cols:
                row[c] = sort_value(m, c)
            out.append(row)
        return out

    def __repr__(self):
        lines = [f"Leaderboard[{self.project_name}] "
                 f"(sort: {self._metric()})"]
        for r in self.as_table():
            lines.append("  " + "  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()))
        return "\n".join(lines)
