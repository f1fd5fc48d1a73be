"""Generic model — an external MOJO as a first-class model.

Reference: h2o3_tpu/models/generic.py (hex/generic/Generic.java): a MOJO
file wrapped in the Model API, so it predicts, is measured and sits on
a leaderboard like a model trained here. The MOJO is the format both
packages write (``genmodel/mojo.py``); it scores on the host through
the port's readers (``genmodel/readers.py``), as the reference's does,
and its metrics come from ``models/metrics.py`` on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.core.kv import make_key
from h2o3_tpu_torch.frame.frame import Frame, raw_columns
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain)


class GenericModel(Model):
    algo = "generic"

    def __init__(self, params, output, mojo):
        super().__init__(params, output)
        self.mojo = mojo

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self.mojo.predict(raw_columns(frame, self.mojo.names))

    def model_performance(self, frame: Frame, mask_weights=None):
        y = self.output.get("response")
        if y is None or y not in frame:
            raise ValueError("response column unavailable for metrics")
        out = self._score_raw(frame)
        cat = self.output["category"]
        n = frame.nrows
        w = frame.valid_weights().cpu().numpy()[:n]
        if mask_weights is not None:
            w = w * np.asarray(mask_weights, np.float32)[:n]
        if cat in (ModelCategory.BINOMIAL, ModelCategory.MULTINOMIAL):
            yv = adapt_domain(frame.col(y), self.output["domain"])
            w = (w * (yv >= 0)).astype(np.float32)
            yt = np.maximum(yv, 0)
            if cat == ModelCategory.BINOMIAL:
                return mm.binomial_metrics(out["p1"], yt.astype(np.float32),
                                           w)
            K = int(self.output.get("nclasses", 2))
            p = np.stack([out[f"p{k}"] for k in range(K)], axis=1)
            import torch
            return mm.multinomial_metrics(
                torch.as_tensor(p, dtype=torch.float32),
                torch.as_tensor(yt.astype(np.int64)), w,
                domain=self.output["domain"])
        yv = frame.col(y).to_numpy()
        ok = np.isfinite(yv)
        return mm.regression_metrics(np.asarray(out["predict"])[ok], yv[ok],
                                     w[ok].astype(np.float32))


class GenericEstimator(ModelBuilder):
    """h2o-py H2OGenericEstimator surface: ``train()`` imports the MOJO
    at ``path`` (with no frame, or with one to measure it on)."""

    algo = "generic"
    label = "Generic"
    DEFAULTS = {"path": None, "model_key": None}
    PORTED = frozenset(DEFAULTS)

    def __init__(self, **params):
        if "path" not in params and "model_key" not in params:
            raise ValueError("GenericEstimator requires path=<mojo zip>")
        super().__init__(**params)

    def _fit(self, frame: Optional[Frame], x: Sequence[str],
             y: Optional[str], validation_frame=None) -> Model:
        from h2o3_tpu_torch.genmodel import load_mojo
        mojo = load_mojo(self.params["path"])
        output = {
            "category": mojo.category,
            "response": mojo.meta.get("response"),
            "names": mojo.names,
            "domain": mojo.domain,
            "nclasses": mojo.nclasses,
            "default_threshold": mojo.meta.get("default_threshold", 0.5),
            "source_algo": mojo.algo,
        }
        model = GenericModel(self.params, output, mojo)
        if frame is not None and output["response"] in frame.names:
            model.training_metrics = model.model_performance(frame)
        return model

    def train(self, training_frame: Optional[Frame] = None, y=None, x=None,
              validation_frame=None, background: bool = False,
              dest_key: Optional[str] = None, custom_metric_func=None):
        """Import the MOJO; with a ``training_frame`` (whose response the
        MOJO names) its training metrics are measured on it."""
        if training_frame is not None:
            return super().train(training_frame, y=y, x=x,
                                 validation_frame=validation_frame,
                                 background=background, dest_key=dest_key,
                                 custom_metric_func=custom_metric_func)
        dest_key = dest_key or make_key(f"model_{self.algo}")

        def _run(_job):
            model = self._fit(None, [], None)
            model._store(dest_key)
            return model
        job = Job("generic import", work=1.0, dest=dest_key)
        job.start(_run, background=background)
        return job if background else job.result
