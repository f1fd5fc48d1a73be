"""Distribution / loss family for GBM.

Reference: h2o3_tpu/models/distribution.py. Each family supplies, on the
margin scale f: ``grad``/``hess`` (d/df and d²/df² of the per-row
deviance, consumed by Newton boosting), ``init_margin`` (prior f0, host
scalar), ``link_inv`` (margin → prediction) and ``deviance``.

Families: gaussian, bernoulli, poisson, gamma, tweedie(p), laplace,
quantile(alpha) and huber(delta), with the reference's own
simplifications (laplace's prior is the mean; huber's delta is fixed at
``huber_alpha``). Multinomial is resolved at the algorithm level.
``custom`` wraps an object uploaded with
``core/udf.upload_custom_distribution`` (``custom_distribution_func``):
its ``gradient`` and optional ``hessian``, ``deviance``, ``init`` and
``link`` take and return torch tensors on the fit's device.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable

import numpy as np
import torch

EPS = 1e-7  # float32-safe: 1 - 1e-7 != 1.0


@dataclasses.dataclass(frozen=True)
class Distribution:
    name: str
    grad: Callable         # (y, f) -> g
    hess: Callable         # (y, f) -> h
    init_margin: Callable  # (mean_y) -> f0  (scalar, host)
    link_inv: Callable     # f -> prediction
    deviance: Callable     # (y, f) -> per-row deviance


def _sigmoid(f):
    return torch.clamp(1.0 / (1.0 + torch.exp(-f)), EPS, 1.0 - EPS)


_f32 = np.float32


def _fma32(a, b, c) -> np.float32:
    """a·b + c rounded once to float32 (exact rational arithmetic, then
    the nearest float32, ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = _f32(float(v))
    cands = (np.nextafter(r, _f32(-np.inf)), r,
             np.nextafter(r, _f32(np.inf)))
    err = [abs(Fraction(float(x)) - v) for x in cands]
    best = min(err)
    ties = [x for x, e in zip(cands, err) if e == best]
    return min(ties, key=lambda x: int(np.array(x).view(np.int32)) & 1)


# Cephes log coefficients (Eigen's plog, float32)
_LOG_P = [_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1)]
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def _log_f32(m: float) -> float:
    """float32 natural log of a positive host scalar, bit for bit as the
    reference computes its priors (``float(jnp.log(m))`` on the CPU: the
    Cephes polynomial of Eigen's plog, with fused multiply-adds where the
    compiler contracts them). ``torch.log`` is correctly rounded and
    differs from it in the last bit for some inputs."""
    x = max(_f32(m), _f32(1.17549435e-38))
    bits = int(np.array(x, np.float32).view(np.int32))
    e = _f32(((bits >> 23) & 0xFF) - 0x7F) + _f32(1)
    x = np.array((bits & ~0x7F800000) | 0x3F000000, np.int32).view(
        np.float32)[()]
    small = x < _f32(0.707106781186547524)
    tmp = x if small else _f32(0)
    x = _f32(x - _f32(1))
    e = _f32(e - (_f32(1) if small else _f32(0)))
    x = _f32(x + tmp)
    x2 = _f32(x * x)
    x3 = _f32(x2 * x)
    p = _LOG_P
    y = _fma32(x, p[0], p[1])
    y1 = _fma32(x, p[3], p[4])
    y2 = _fma32(x, p[6], p[7])
    y = _fma32(y, x, p[2])
    y1 = _fma32(y1, x, p[5])
    y2 = _fma32(y2, x, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, _f32(_LOG_Q1 * e))
    x = _f32(x - _f32(x2 * _f32(0.5)))
    x = _f32(x + y)
    return float(_f32(x + _f32(_LOG_Q2 * e)))


def log_f32(m: torch.Tensor) -> torch.Tensor:
    """``_log_f32`` on a tensor of positive values: the same polynomial
    in float32 ops, each fused multiply-add taken in float64 (the product
    of two float32 values is exact there) and rounded once to float32,
    so it gives the reference's float32 ``jnp.log`` bits, where the
    correctly rounded ``torch.log`` differs in the last bit for some
    inputs."""
    f32, f64 = torch.float32, torch.float64
    x = torch.clamp_min(m.to(f32), 1.17549435e-38)
    bits = x.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 0x7F).to(f32) + 1.0
    x = ((bits & ~0x7F800000) | 0x3F000000).view(f32)
    small = x < 0.707106781186547524
    tmp = torch.where(small, x, 0.0)
    x = x - 1.0
    e = e - small.to(f32)
    x = x + tmp
    x2 = x * x
    x3 = x2 * x

    def fma(a, b, c):
        b = b.to(f64) if isinstance(b, torch.Tensor) else float(b)
        c = c.to(f64) if isinstance(c, torch.Tensor) else float(c)
        return (a.to(f64) * b + c).to(f32)

    p = _LOG_P
    y = fma(x, p[0], p[1])
    y1 = fma(x, p[3], p[4])
    y2 = fma(x, p[6], p[7])
    y = fma(y, x, p[2])
    y1 = fma(y1, x, p[5])
    y2 = fma(y2, x, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * float(_LOG_Q1))
    x = x - x2 * 0.5
    x = x + y
    return x + e * float(_LOG_Q2)


def _logit_f32(m: float) -> float:
    """float32 log-odds of a host mean, as the reference takes it."""
    return _log_f32(max(m, EPS) / max(1.0 - m, EPS))


def _log_mean_f32(m: float) -> float:
    """The log-link families' prior: float32 log of the host mean."""
    return _log_f32(max(m, EPS))


def gaussian() -> Distribution:
    return Distribution(
        "gaussian",
        grad=lambda y, f: f - y,
        hess=lambda y, f: torch.ones_like(f),
        init_margin=lambda m: m,
        link_inv=lambda f: f,
        deviance=lambda y, f: (y - f) ** 2)


def bernoulli() -> Distribution:
    return Distribution(
        "bernoulli",
        grad=lambda y, f: _sigmoid(f) - y,
        hess=lambda y, f: _sigmoid(f) * (1.0 - _sigmoid(f)),
        init_margin=_logit_f32,
        link_inv=_sigmoid,
        deviance=lambda y, f: -2.0 * (y * torch.log(_sigmoid(f))
                                      + (1 - y) * torch.log(1 - _sigmoid(f))))


def poisson() -> Distribution:
    return Distribution(
        "poisson",
        grad=lambda y, f: torch.exp(f) - y,
        hess=lambda y, f: torch.exp(f),
        init_margin=_log_mean_f32,
        link_inv=torch.exp,
        deviance=lambda y, f: 2.0 * (y * torch.log(torch.clamp_min(y, EPS))
                                     - y * f - y + torch.exp(f)))


def gamma() -> Distribution:
    return Distribution(
        "gamma",
        grad=lambda y, f: 1.0 - y * torch.exp(-f),
        hess=lambda y, f: y * torch.exp(-f),
        init_margin=_log_mean_f32,
        link_inv=torch.exp,
        deviance=lambda y, f: 2.0 * (y * torch.exp(-f) - 1.0
                                     - torch.log(torch.clamp_min(y, EPS))
                                     + f))


def tweedie(p: float = 1.5) -> Distribution:
    return Distribution(
        "tweedie",
        grad=lambda y, f: -y * torch.exp((1 - p) * f)
        + torch.exp((2 - p) * f),
        hess=lambda y, f: -(1 - p) * y * torch.exp((1 - p) * f)
        + (2 - p) * torch.exp((2 - p) * f),
        init_margin=_log_mean_f32,
        link_inv=torch.exp,
        deviance=lambda y, f: 2.0 * (
            torch.clamp_min(y, 0.0) ** (2 - p) / ((1 - p) * (2 - p))
            - y * torch.exp((1 - p) * f) / (1 - p)
            + torch.exp((2 - p) * f) / (2 - p)))


def laplace() -> Distribution:
    return Distribution(
        "laplace",
        grad=lambda y, f: torch.sign(f - y),
        hess=lambda y, f: torch.ones_like(f),
        init_margin=lambda m: m,   # the reference's prior is the mean
        link_inv=lambda f: f,
        deviance=lambda y, f: torch.abs(y - f))


def quantile(alpha: float = 0.5) -> Distribution:
    return Distribution(
        "quantile",
        grad=lambda y, f: torch.where(y > f, -alpha, 1.0 - alpha),
        hess=lambda y, f: torch.ones_like(f),
        init_margin=lambda m: m,
        link_inv=lambda f: f,
        deviance=lambda y, f: torch.where(y > f, alpha * (y - f),
                                          (1 - alpha) * (f - y)))


def huber(delta: float = 0.9) -> Distribution:
    # fixed delta, as the reference has it (no per-iteration re-estimate)
    return Distribution(
        "huber",
        grad=lambda y, f: torch.clamp(f - y, -delta, delta),
        hess=lambda y, f: torch.ones_like(f),
        init_margin=lambda m: m,
        link_inv=lambda f: f,
        deviance=lambda y, f: torch.where(
            torch.abs(y - f) <= delta, 0.5 * (y - f) ** 2,
            delta * (torch.abs(y - f) - 0.5 * delta)))


_LINKS = {
    "identity": (lambda f: f, lambda m: m),
    "log": (torch.exp, lambda m: float(np.log(np.float32(max(m, EPS))))),
    "logit": (_sigmoid, lambda m: float(np.log(np.float32(
        max(m, EPS) / max(1.0 - m, EPS))))),
}


def custom(obj, ref: str) -> Distribution:
    """An uploaded custom-distribution object as a family (the
    CustomDistribution role): the hessian defaults to 1, the deviance to
    |gradient| (a monotone progress measure for early stopping), the
    prior to the link's."""
    link_name = obj.link() if callable(getattr(obj, "link", None)) \
        else "identity"
    if link_name not in _LINKS:
        raise ValueError(f"custom distribution link '{link_name}' must "
                         f"be one of {sorted(_LINKS)}")
    link_inv, default_init = _LINKS[link_name]
    grad = obj.gradient
    hess = (obj.hessian if callable(getattr(obj, "hessian", None))
            else (lambda y, f: torch.ones_like(f)))
    dev = (obj.deviance if callable(getattr(obj, "deviance", None))
           else (lambda y, f: torch.abs(grad(y, f))))
    init = (obj.init if callable(getattr(obj, "init", None))
            else default_init)
    return Distribution(f"custom:{ref}", grad=grad, hess=hess,
                        init_margin=init, link_inv=link_inv, deviance=dev)


_FACTORY = {"gaussian": gaussian, "bernoulli": bernoulli, "poisson": poisson,
            "gamma": gamma, "laplace": laplace}
# families with a shape parameter: (factory, the GBM parameter, default)
_SHAPED = {"tweedie": (tweedie, "tweedie_power", 1.5),
           "quantile": (quantile, "quantile_alpha", 0.5),
           "huber": (huber, "huber_alpha", 0.9)}
FAMILIES = tuple(sorted(set(_FACTORY) | set(_SHAPED)))
_CACHE: dict = {}


def get_distribution(name: str, **kw) -> Distribution:
    """The named family, one shared instance per (name, shape parameter);
    ``kw`` may hold any estimator parameters, of which ``tweedie_power``,
    ``quantile_alpha`` and ``huber_alpha`` are read."""
    name = name.lower()
    if name in ("auto", "multinomial"):
        raise ValueError(f"{name} resolved at the algorithm level")
    if name == "custom":
        ref = kw.get("custom_distribution_func")
        if not ref:
            raise ValueError("distribution='custom' requires "
                             "custom_distribution_func (upload via "
                             "h2o3_tpu_torch.upload_custom_distribution)")
        from h2o3_tpu_torch.core.udf import resolve_udf
        obj = resolve_udf(ref)
        # one instance per uploaded object: a re-upload under the same
        # key is a new family
        key = ("custom", str(ref), id(obj))
        if key not in _CACHE:
            _CACHE[key] = custom(obj, str(ref))
        return _CACHE[key]
    if name in _SHAPED:
        make, param, default = _SHAPED[name]
        key = (name, float(kw.get(param, default)))
        if key not in _CACHE:
            _CACHE[key] = make(key[1])
        return _CACHE[key]
    if name not in _FACTORY:
        raise ValueError(f"unknown distribution '{name}' (known: "
                         f"{list(FAMILIES)})")
    key = (name, 0.0)
    if key not in _CACHE:
        _CACHE[key] = _FACTORY[name]()
    return _CACHE[key]
