"""Distribution / loss family for GBM: bernoulli and gaussian.

Reference: h2o3_tpu/models/distribution.py. Each family supplies, on the
margin scale f: ``grad``/``hess`` (d/df and d²/df² of the per-row
deviance, consumed by Newton boosting), ``init_margin`` (prior f0, host
scalar), ``link_inv`` (margin → prediction) and ``deviance``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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


def _logit_f32(m: float) -> float:
    """float32 log-odds of a host mean, as the reference takes it."""
    r = torch.tensor(max(m, EPS) / max(1.0 - m, EPS), dtype=torch.float32)
    return float(torch.log(r))


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


_FACTORY = {"gaussian": gaussian, "bernoulli": bernoulli}
_CACHE: dict = {}


def get_distribution(name: str) -> Distribution:
    """The named family (one shared instance per name). Other families
    of the reference are not ported yet and raise."""
    name = name.lower()
    if name in ("auto", "multinomial"):
        raise ValueError(f"{name} resolved at the algorithm level")
    if name not in _FACTORY:
        raise NotImplementedError(
            f"distribution '{name}' is not ported yet (ported: "
            f"{sorted(_FACTORY)})")
    if name not in _CACHE:
        _CACHE[name] = _FACTORY[name]()
    return _CACHE[name]
