"""AutoML — the step-provider modeling plan under a budget.

Reference: h2o3_tpu/automl/__init__.py (ai/h2o/automl/AutoML.java:49):
``modeling_plan`` (``automl/steps.py``) lists the steps of every
allowed provider by priority group; ``train`` runs the groups in order
(each group a barrier: the exploitation step reads the leaderboard the
groups before it made) under ``max_models`` / ``max_runtime_secs`` with
a per-model cap (``automl/executor.py``), every model cross-validated
and ranked on the ``Leaderboard``, then the two StackedEnsembles
(best of family, all models). ``preprocessing=["target_encoding"]``
target-encodes categorical predictors of 25 levels or more first. A
step that raises is logged as an ``error`` event, one cancelled at its
cap as a ``timeout`` event (``event_log``).

Steps within a group run on ``H2O3TPU_AUTOML_PARALLEL`` worker threads
(default 1, as in the reference: one card). Not ported: ``recovery_dir``
and ``resume_automl`` (ROADMAP A #13).
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import List, Optional, Sequence

from h2o3_tpu_torch.automl.executor import Budget, run_step, train_capped
from h2o3_tpu_torch.automl.steps import modeling_plan
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.ml.ensemble import StackedEnsembleEstimator
from h2o3_tpu_torch.ml.leaderboard import Leaderboard
from h2o3_tpu_torch.models import get_builder

log = logging.getLogger("h2o3_tpu_torch.automl")


class H2OAutoML:
    """h2o-py H2OAutoML surface (h2o-py/h2o/automl/).

    ``keep_cross_validation_predictions`` is always on in effect (the
    holdouts stay in memory for stacking); ``balance_classes`` is not
    implemented and logs a warning; ``verbosity`` only affects
    logging."""

    def __init__(self, max_models: int = 0, max_runtime_secs: float = 3600.0,
                 seed: int = -1, nfolds: int = 5,
                 project_name: Optional[str] = None,
                 sort_metric: Optional[str] = None,
                 include_algos: Optional[Sequence[str]] = None,
                 exclude_algos: Optional[Sequence[str]] = None,
                 stopping_rounds: int = 3, stopping_tolerance: float = 1e-3,
                 keep_cross_validation_predictions: bool = True,
                 verbosity: str = "warn", balance_classes: bool = False,
                 max_runtime_secs_per_model: float = 0.0,
                 preprocessing: Optional[Sequence[str]] = None,
                 recovery_dir: Optional[str] = None):
        if recovery_dir:
            raise NotImplementedError(
                "H2OAutoML recovery_dir is not ported yet: its snapshots "
                "and resume_automl wait for core/recovery.py (ROADMAP "
                "A #13)")
        self.max_models = int(max_models)
        self.max_runtime_secs = float(max_runtime_secs)
        self.seed = int(seed) if int(seed) >= 0 else 5723
        # h2o-py sends nfolds=-1 for "auto": 5-fold CV
        self.nfolds = 5 if int(nfolds) == -1 else int(nfolds)
        self.project_name = project_name or f"automl_{int(time.time())}"
        self.sort_metric = sort_metric
        self.include = ({a.lower() for a in include_algos}
                        if include_algos else None)
        self.exclude = {a.lower() for a in (exclude_algos or ())}
        self.leaderboard_obj = Leaderboard(self.project_name, sort_metric)
        self.stopping_rounds = int(stopping_rounds)
        self.stopping_tolerance = float(stopping_tolerance)
        self.max_runtime_secs_per_model = float(max_runtime_secs_per_model)
        self.preprocessing = list(preprocessing or [])
        self.event_log: List[dict] = []
        self._te_model = None
        if balance_classes:
            log.warning("balance_classes is not implemented; ignoring")

    def _allowed(self, algo: str) -> bool:
        a = algo.lower()
        if self.include is not None and a not in self.include:
            return False
        return a not in self.exclude

    @property
    def leader(self):
        return self.leaderboard_obj.leader

    @property
    def leaderboard(self):
        return self.leaderboard_obj

    def predict(self, frame: Frame) -> Frame:
        """The leader's predictions (target-encoded first when the run
        encoded its training frame)."""
        if self._te_model is not None:
            frame = self._te_model.transform(frame)
        return self.leader.predict(frame)

    def _maybe_target_encode(self, frame: Frame, y: str, x):
        """TargetEncoding preprocessing (ai/h2o/automl/preprocessing/
        TargetEncoding.java): categorical predictors of 25 levels or
        more get leave-one-out encodings; returns (frame, model) or
        (frame, None)."""
        if "target_encoding" not in self.preprocessing:
            return frame, None
        high_card = [n for n in (x or frame.names)
                     if n != y and frame.col(n).is_categorical
                     and frame.col(n).cardinality >= 25]
        if not high_card:
            return frame, None
        from h2o3_tpu_torch.models.targetencoder import \
            TargetEncoderEstimator
        te = TargetEncoderEstimator(
            data_leakage_handling="loo", noise=0.01,
            blending=True, seed=self.seed).train(frame, y=y, x=high_card)
        enc = te.transform(frame, as_training=True)
        self._log_event("preprocessing", f"target-encoded {high_card}")
        return enc, te

    def _log_event(self, stage: str, message: str):
        self.event_log.append({"timestamp": time.time(), "stage": stage,
                               "message": message})
        log.info("automl[%s]: %s", stage, message)

    def _lr_annealing_step(self, budget, training_frame, y, x):
        """Exploitation (GBMStepsProvider lr_annealing): the best GBM so
        far again with twice the trees (at least 100) and half the learn
        rate."""
        best_gbm = next((m for m in self.leaderboard_obj.sorted_models()
                         if m.algo == "gbm"), None)
        if best_gbm is None:
            return None
        params = {k: v for k, v in best_gbm.params.items()
                  if k in get_builder("gbm").accepted_params()}
        params.update(ntrees=max(int(params.get("ntrees", 50) * 2), 100),
                      learn_rate=float(params.get("learn_rate", 0.1)) * 0.5,
                      stopping_rounds=3, nfolds=self.nfolds)
        return train_capped(get_builder("gbm")(**params),
                            training_frame, y, x, budget)

    def _ensemble(self, step_id: str, base, training_frame, y, x) -> None:
        """Train one StackedEnsemble step onto the leaderboard; a failure
        is an ``error`` event."""
        try:
            se = StackedEnsembleEstimator(base_models=base).train(
                training_frame, y=y, x=x)
            se.output["automl_step"] = step_id
            self.leaderboard_obj.add(se)
        except Exception as e:   # noqa: BLE001 - logged, as the reference
            self._log_event("error", f"{step_id} failed: {e}")

    def train(self, y: str, training_frame: Frame,
              x: Optional[Sequence[str]] = None,
              validation_frame: Optional[Frame] = None,
              leaderboard_frame: Optional[Frame] = None):
        """Run the plan; returns the leader."""
        t0 = time.time()
        budget = Budget(self.max_models, self.max_runtime_secs,
                        self.max_runtime_secs_per_model)
        plan = modeling_plan(self.seed, include=self.include,
                             exclude=self.exclude)
        self._log_event("init", f"plan: {[st.id for st in plan]}")
        training_frame, te_model = self._maybe_target_encode(
            training_frame, y, x)
        self._te_model = te_model
        if te_model is not None and x is not None:
            # an explicit predictor list takes the encoded columns too
            x = list(x) + [c for c in training_frame.names
                           if c.endswith("_te")]
        trained: List = []
        par = int(os.environ.get("H2O3TPU_AUTOML_PARALLEL", "0") or 0)
        par = max(par, 1)       # one card: one step at a time by default
        groups = sorted({s.group for s in plan if s.kind != "ensemble"})
        for g in groups:
            if budget.exhausted():
                self._log_event("budget", "budget exhausted; stopping plan")
                break
            steps_g = [s for s in plan
                       if s.group == g and s.kind != "ensemble"]
            with ThreadPoolExecutor(max_workers=par) as ex:
                futs = {ex.submit(run_step, self, s, budget,
                                  training_frame, y, x): s
                        for s in steps_g}
                for fut in as_completed(futs):
                    step = futs[fut]
                    try:
                        models = fut.result()
                    except TimeoutError as e:
                        self._log_event("timeout", f"{step.id}: {e}")
                        continue
                    except Exception as e:   # noqa: BLE001 - logged
                        self._log_event("error", f"{step.id} failed: {e}")
                        continue
                    if not models:
                        continue
                    trained.extend(models)
                    self.leaderboard_obj.add(*models)
                    self._log_event(
                        "model", f"{step.id} done ({budget.trained} "
                        f"models, {time.time() - t0:.0f}s)")

        # the stacked ensembles last: best of family, then all models
        with_cv = [m for m in trained
                   if getattr(m, "_cv_holdout", None) is not None]
        if self._allowed("stackedensemble") and len(with_cv) >= 2:
            best_of_family = {}
            for m in self.leaderboard_obj.sorted_models():
                if m in with_cv and m.algo not in best_of_family:
                    best_of_family[m.algo] = m
            if len(best_of_family) >= 2:
                self._ensemble("StackedEnsemble_BestOfFamily",
                               list(best_of_family.values()),
                               training_frame, y, x)
            if len(with_cv) > max(2, len(best_of_family)):
                self._ensemble("StackedEnsemble_AllModels", with_cv[:10],
                               training_frame, y, x)
        self._log_event("done",
                        f"{len(self.leaderboard_obj.models)} models in "
                        f"{time.time() - t0:.0f}s; leader="
                        f"{self.leader.key if self.leader else None}")
        return self.leader


def resume_automl(recovery_dir: str, training_frame: Frame,
                  validation_frame: Optional[Frame] = None,
                  leaderboard_frame: Optional[Frame] = None) -> H2OAutoML:
    """Resume a killed AutoML run from its recovery snapshots: not
    ported (ROADMAP A #13)."""
    raise NotImplementedError(
        "resume_automl is not ported yet: AutoML snapshots wait for "
        "core/recovery.py (ROADMAP A #13)")
