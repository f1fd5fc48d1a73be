"""AutoML step executor — budget accounting, the per-model cap and one
step's execution.

Reference: h2o3_tpu/automl/executor.py (ai/h2o/automl/
ModelingStepsExecutor, driven from AutoML.java:760 learn). Every step
runs under the run's ``max_models`` / ``max_runtime_secs``; each model
trains as a background Job that a ``threading.Timer`` cancels when the
per-model cap expires. A builder that takes ``max_runtime_secs`` (GBM,
DRF, XGBoost) gets the cap as its own and stops gracefully after the
tree at which it passed, keeping its trees; the timer is then a
backstop at 1.5 × cap + 30 s. Any other builder (GLM, DeepLearning) is
cancelled at the cap, observed at its next ``job.update``, and the step
raises ``TimeoutError``.

Not ported: ``recovery_dir`` snapshots (ROADMAP A #13) and the
cluster-scheduled step (``parallel/scheduler.py``, A #12/#13): a step
trains on this process's device, and on a scheduled cloud (the
reference's ``H2O3TPU_SCHEDULER`` on, or auto on a cloud of several
processes) it raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from h2o3_tpu_torch.core.job import CANCELLED, DONE


class Budget:
    """max_models / max_runtime_secs / per-model cap accounting
    (AutoML.java planWork time allocation)."""

    def __init__(self, max_models: int, max_runtime_secs: float,
                 per_model_secs: float):
        self.max_models = max_models or 10 ** 9
        self.deadline = (time.time() + max_runtime_secs
                         if max_runtime_secs else None)
        self.per_model_secs = per_model_secs
        self.trained = 0
        self.inflight = 0
        self._lock = threading.Lock()   # steps may train in parallel

    def add_trained(self, k: int = 1) -> None:
        with self._lock:
            self.trained += k

    def try_start(self) -> bool:
        """Reserve one model slot before a step starts, so parallel
        workers cannot all pass ``exhausted`` and overshoot
        ``max_models``."""
        with self._lock:
            if self.trained + self.inflight >= self.max_models:
                return False
            if self.deadline is not None and time.time() > self.deadline:
                return False
            self.inflight += 1
            return True

    def finish(self, trained_count: int) -> None:
        """Release the reserved slot; count what actually trained."""
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            self.trained += trained_count

    def exhausted(self) -> bool:
        if self.trained >= self.max_models:
            return True
        return self.deadline is not None and time.time() > self.deadline

    def remaining_models(self) -> int:
        return max(0, self.max_models - self.trained)

    def remaining_secs(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - time.time())

    def model_cap(self) -> Optional[float]:
        """The per-model wall-clock cap: the explicit cap, bounded by
        what is left of the run's budget and time-sliced over the models
        still to train (at least 60 s), so one slow model cannot eat the
        plan."""
        caps = []
        if self.per_model_secs:
            caps.append(self.per_model_secs)
        rem = self.remaining_secs()
        if rem is not None:
            with self._lock:
                left = max(1, self.max_models - self.trained
                           - self.inflight + 1)
            caps.append(max(60.0, rem / min(left, 8)))
            caps.append(rem)
        return min(caps) if caps else None


def train_capped(builder, frame, y, x, budget: Budget):
    """Train one model under the per-model cap (see the module
    docstring); raises ``TimeoutError`` when the job was cancelled at
    the cap and ``RuntimeError`` with the traceback when it failed."""
    cap = budget.model_cap()
    graceful = bool(cap) and "max_runtime_secs" in builder.accepted_params()
    if graceful:
        builder.set_max_runtime(cap)
    job = builder.train(frame, y=y, x=x, background=True)
    timer = None
    if cap:
        timer = threading.Timer(cap * 1.5 + 30.0 if graceful else cap,
                                job.cancel)
        timer.daemon = True
        timer.start()
    job.join()
    if timer:
        timer.cancel()
    if job.status == CANCELLED:
        raise TimeoutError(
            f"max_runtime_secs_per_model ({cap:.0f}s) exceeded")
    if job.status != DONE:
        raise RuntimeError(job.exception or f"job {job.status}")
    return job.result


def run_step(aml, step, budget: Budget, training_frame, y, x) -> List:
    """Execute one modeling step; returns the models it trained. A
    budget slot is reserved first; only the caller touches the
    leaderboard."""
    from h2o3_tpu_torch.ml.grid import GridSearch
    from h2o3_tpu_torch.models import get_builder
    if not budget.try_start():
        return []
    trained_count = 0
    try:
        if step.kind == "exploitation":
            m = aml._lr_annealing_step(budget, training_frame, y, x)
            if m is None:
                return []
            m.output["automl_step"] = step.id
            trained_count = 1
            return [m]
        cls = get_builder(step.algo)
        if step.kind == "grid":
            rem_s = budget.remaining_secs()
            gs = GridSearch(
                cls, step.hyper,
                search_criteria={
                    "strategy": "RandomDiscrete",
                    "max_models": min(budget.remaining_models(),
                                      step.grid_models),
                    "max_runtime_secs": rem_s or 0,
                    "seed": aml.seed},
                **{**step.params, "nfolds": aml.nfolds})
            grid = gs.train(training_frame, y=y, x=x)
            for m in grid.models:
                m.output["automl_step"] = step.id
            trained_count = len(grid.models)
            return list(grid.models)
        params = {**step.params, "nfolds": aml.nfolds}
        if "stopping_rounds" in getattr(cls, "DEFAULTS", {}):
            params.setdefault("stopping_rounds", aml.stopping_rounds)
            params.setdefault("stopping_tolerance", aml.stopping_tolerance)
        params = {k: v for k, v in params.items()
                  if k in cls.accepted_params()}
        m = _train_plain(cls, params, training_frame, y, x, budget)
        m.output["automl_step"] = step.id
        trained_count = 1
        return [m]
    finally:
        budget.finish(trained_count)


def scheduled_cloud() -> bool:
    """The reference's scheduler gate: ``H2O3TPU_SCHEDULER`` on, or auto
    (the default) on a cloud of more than one process."""
    mode = os.environ.get("H2O3TPU_SCHEDULER", "auto").strip().lower()
    if mode in ("off", "0", "false"):
        return False
    if mode in ("on", "1", "true"):
        return True
    from h2o3_tpu_torch.parallel import mesh as mesh_mod
    return mesh_mod.get_mesh().world_size > 1


def _train_plain(cls, params, training_frame, y, x, budget: Budget):
    """Train one plain-model step on this process's device."""
    if scheduled_cloud():
        raise NotImplementedError(
            "AutoML steps on a scheduled cloud are not ported yet: the "
            "cluster scheduler parallel/scheduler.py waits for ROADMAP "
            "A #12/#13")
    return train_capped(cls(**params), training_frame, y, x, budget)
