"""User-defined functions — custom distributions and custom metrics.

Reference: h2o3_tpu/core/udf.py (water/udf/CFunc.java:1). A user
uploads a Python object into the DKV and passes its ``"python:<key>"``
reference as ``custom_distribution_func`` or ``custom_metric_func``.

A custom DISTRIBUTION supplies torch callables on the boosting loop's
device tensors:

    class AsymmetricLoss:
        def link(self): return "identity"
        def gradient(self, y, f): return torch.where(f > y, 2.0, -1.0)
        # optional: hessian(y, f), deviance(y, f), init(mean)

    ref = h2o3_tpu_torch.upload_custom_distribution(AsymmetricLoss())
    GBMEstimator(distribution="custom", custom_distribution_func=ref)

A custom METRIC is a host callable ``fn(y, preds_dict, w) -> float``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from h2o3_tpu_torch.core.kv import DKV, make_key

_PREFIX = "python:"


def upload_custom_distribution(obj: Any, key: Optional[str] = None) -> str:
    """Register a custom-distribution object; returns its reference.

    ``obj`` must provide ``gradient(y, f)``. Optional: ``link() -> str``
    (identity/log/logit, default identity), ``hessian(y, f)`` (default
    1), ``deviance(y, f)``, ``init(mean) -> float``."""
    if isinstance(obj, type):
        obj = obj()
    if not callable(getattr(obj, "gradient", None)):
        raise ValueError("custom distribution must define gradient(y, f)")
    key = key or make_key("udf_dist")
    DKV.put(key, obj)
    return _PREFIX + key


def upload_custom_metric(fn: Callable, key: Optional[str] = None) -> str:
    """Register a custom metric ``fn(y, preds, w) -> float``; returns its
    reference."""
    if not callable(fn):
        raise ValueError("custom metric must be callable")
    key = key or make_key("udf_metric")
    DKV.put(key, fn)
    return _PREFIX + key


def resolve_udf(ref: Any) -> Any:
    """``"python:key"`` → the registered object; callables pass
    through."""
    if callable(ref) and not isinstance(ref, str):
        return ref
    if isinstance(ref, str):
        key = ref[len(_PREFIX):] if ref.startswith(_PREFIX) else ref
        obj = DKV.get(key.strip('"'))
        if obj is None:
            raise ValueError(f"no uploaded UDF under '{ref}'")
        return obj
    raise ValueError(f"cannot resolve UDF reference {ref!r}")
