"""GLM — generalized linear models with elastic net.

Reference: h2o3_tpu/models/glm.py (hex/glm/GLM.java): IRLSM (the
weighted Gram of ``ops/gram.py``, then a Cholesky solve, or ADMM under
L1), L-BFGS on the penalized deviance, coordinate descent with box
constraints (``beta_constraints``, ``non_negative``), a warm-started
lambda search, multinomial (block IRLS over the classes, or L-BFGS on
the softmax) and ordinal (proportional odds, L-BFGS); every family and
link of the reference. The design is ``frame/datainfo.py``'s dense
float32 matrix with a ones column, on the training frame's device.

What the reference compiles into device loops runs here as torch on
that device with the loop on the host: one IRLS iteration is a Gram pass
and a solve, then the reference's line search (the best of nine steps
{1, 1/2, ..., 1/128, 0} of the Newton step by penalized objective, one
[N, 9] pass) and ONE host sync for the loop condition. ADMM syncs once a
chunk of steps (``ops/optimize.py``). The reference's finite sentinels
(1e30 / -1e30) start the loop as they start its ``while_loop``. L-BFGS
keeps its history on the host in float64 and takes the value and
gradient from ``torch.autograd`` on the same float32 objectives.
Coefficients agree with the reference's within float32 summation order
(the Gram sums in cuBLAS's order, not the reference's 8192-row blocks).

Scoring (``GLMModel``) computes the reference's ``_score_raw`` /
``_serve_dev`` math directly (the serving engine is ROADMAP A #10).
Validation metrics are the base ``train``'s (the reference's
``_finish``). ``beta_constraints`` may be a Frame's DKV key. Not ported:
``fit_glm_batched`` (the vmapped grid bucket) waits for
``parallel/model_batch.py`` (ROADMAP A #9′); GLM on a partitioned frame
for A #12; the in-fit checkpointer and the telemetry spans for A #13.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.job import job_update
from h2o3_tpu_torch.frame.column import T_NUM, Column, column_from_numpy
from h2o3_tpu_torch.frame.datainfo import (build_datainfo, coef_stats,
                                           stats_of)
from h2o3_tpu_torch.frame.frame import Frame, resolve_frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain, infer_category,
                                         masked_weights, require_local)
from h2o3_tpu_torch.ops.gram import exact_f32, gram
from h2o3_tpu_torch.ops.optimize import (admm_l1_quadratic,
                                         cholesky_solve_regularized,
                                         coordinate_descent_quadratic, lbfgs)
from h2o3_tpu_torch.parallel.device import fetch

ORDINAL = "Ordinal"
COD_SWEEPS = 50          # cyclic sweeps of one COD IRLS iteration


# ---- family/link layer (hex/glm/GLMModel.GLMParameters.Family) ----------
class Family:
    """linkinv/variance/deviance on mu; link derivative for IRLS."""

    DEFAULT_LINK = {"gaussian": "identity", "binomial": "logit",
                    "quasibinomial": "logit", "fractionalbinomial": "logit",
                    "poisson": "log", "gamma": "log", "tweedie": "tweedie",
                    "negativebinomial": "log", "multinomial": "multinomial"}
    # the family-link compatibility matrix (GLMParameters validation)
    ALLOWED = {"gaussian": {"identity", "log", "inverse"},
               "binomial": {"logit"}, "quasibinomial": {"logit"},
               "fractionalbinomial": {"logit"},
               "poisson": {"log", "identity"},
               "gamma": {"log", "identity", "inverse"},
               "tweedie": {"tweedie"},
               "negativebinomial": {"log", "identity"},
               "multinomial": {"multinomial"}}

    def __init__(self, name: str, tweedie_power: float = 1.5,
                 link: Optional[str] = None, theta: float = 1e-5):
        self.name = name
        self.p = tweedie_power
        self.theta = theta       # negativebinomial inverse dispersion
        # "family_default" is the wire spelling of "use the default link"
        if link in ("family_default", "auto", ""):
            link = None
        if link is not None and name in self.ALLOWED \
                and link not in self.ALLOWED[name]:
            raise ValueError(
                f"Incompatible link function for selected family: "
                f"link {link} is not supported for family {name}")
        self.link = link or self.DEFAULT_LINK[name]

    def linkinv(self, eta):
        if self.link == "identity":
            return eta
        if self.link == "logit":
            return torch.clamp(torch.sigmoid(eta), 1e-7, 1 - 1e-7)
        if self.link in ("log", "tweedie"):       # tweedie: the log link
            return torch.exp(torch.clamp(eta, -30.0, 30.0))
        if self.link == "inverse":
            return 1.0 / torch.where(torch.abs(eta) < 1e-6,
                                     torch.sign(eta) * 1e-6 + 1e-12, eta)
        raise ValueError(self.link)

    def dmu_deta(self, eta, mu):
        if self.link == "identity":
            return torch.ones_like(eta)
        if self.link == "logit":
            return mu * (1.0 - mu)
        if self.link in ("log", "tweedie"):
            return mu
        if self.link == "inverse":
            return -mu * mu
        raise ValueError(self.link)

    def variance(self, mu):
        if self.name == "gaussian":
            return torch.ones_like(mu)
        if self.name in ("binomial", "quasibinomial", "fractionalbinomial"):
            return mu * (1.0 - mu)
        if self.name == "poisson":
            return torch.clamp_min(mu, 1e-10)
        if self.name == "gamma":
            return torch.clamp_min(mu * mu, 1e-10)
        if self.name == "tweedie":
            return torch.clamp_min(mu, 1e-10) ** self.p
        if self.name == "negativebinomial":
            th = max(self.theta, 1e-10)       # var = mu + theta·mu²
            return torch.clamp_min(mu * (1.0 + th * mu), 1e-10)
        raise ValueError(self.name)

    def deviance(self, y, mu):
        """Unit deviance (ModelMetricsRegressionGLM residual deviance)."""
        if self.name == "gaussian":
            return (y - mu) ** 2
        if self.name in ("binomial", "quasibinomial", "fractionalbinomial"):
            mu = torch.clamp(mu, 1e-7, 1 - 1e-7)
            return -2.0 * (y * torch.log(mu) + (1 - y) * torch.log1p(-mu))
        if self.name == "poisson":
            return 2.0 * (_ylogy(y, mu) - (y - mu))
        if self.name == "gamma":
            yr = torch.clamp_min(y, 1e-10) / torch.clamp_min(mu, 1e-10)
            return 2.0 * (-torch.log(yr) + yr - 1.0)
        if self.name == "tweedie":
            p = self.p
            return 2.0 * (torch.clamp_min(y, 0.0) ** (2 - p)
                          / ((1 - p) * (2 - p))
                          - y * mu ** (1 - p) / (1 - p)
                          + mu ** (2 - p) / (2 - p))
        if self.name == "negativebinomial":
            th = max(self.theta, 1e-10)
            return 2.0 * (_ylogy(y, mu) - (y + 1.0 / th) * torch.log(
                (1.0 + th * y) / (1.0 + th * mu)))
        raise ValueError(self.name)


def _ylogy(y, mu):
    return torch.where(y > 0, y * torch.log(torch.clamp_min(y, 1e-10) / mu),
                       0.0)


def _f32(v, dev) -> torch.Tensor:
    """A float32 0-d tensor: the reference's ``jnp.float32`` of a host
    number (float64 rounded once)."""
    return torch.tensor(np.float32(v), device=dev)


def _penalize(Pp1: int, dev) -> torch.Tensor:
    """1 for every coefficient but the intercept (the last)."""
    m = torch.ones((Pp1,), dtype=torch.float32, device=dev)
    m[-1] = 0.0
    return m


def _working(fam: Family, X1, coef, y, w, off):
    """IRLS working response (net of the offset) and weights."""
    eta = X1 @ coef + off
    mu = fam.linkinv(eta)
    d = fam.dmu_deta(eta, mu)
    z = eta - off + (y - mu) / torch.where(torch.abs(d) < 1e-10, 1e-10, d)
    w_irls = w * d * d / torch.clamp_min(fam.variance(mu), 1e-10)
    return mu, z, w_irls


def _normal_equations(X1, w_irls, z, w):
    """(A, q): the Gram and X'Wz over nobs = max(sum w, 1)."""
    xtx, xtz, _ = gram(X1, w_irls, z)
    nobs = torch.clamp_min(w.sum(), 1.0)
    return xtx / nobs, xtz / nobs


def _irls_iter(X1, coef, y, w, off, l1, l2, fam: Family, *, use_l1: bool):
    """One IRLS iteration: re-weight → Gram → penalized solve (ADMM under
    L1, else the ridge-regularized Cholesky). Returns (coef, delta)."""
    _, z, w_irls = _working(fam, X1, coef, y, w, off)
    A, q = _normal_equations(X1, w_irls, z, w)
    pen = _penalize(X1.shape[1], X1.device)
    if use_l1:
        new = admm_l1_quadratic(A + l2 * torch.diag(pen), q, l1, pen)
    else:
        new = cholesky_solve_regularized(A, q, l2, pen)
    return new, torch.max(torch.abs(new - coef))


def first_argmin(objs):
    """``jnp.argmin``'s pick on a float vector: the first NaN if there
    is one, else the first of the tied minima (inf included)."""
    n = objs.shape[0]
    ar = torch.arange(n, device=objs.device)
    isn = torch.isnan(objs)
    k_nan = torch.where(isn, ar, n).min()
    mn = torch.where(isn, torch.inf, objs).min()
    k_min = torch.where(objs == mn, ar, n).min()
    return torch.where(k_nan < n, k_nan, k_min)


def _irls_solve(X1, coef, y, w, off, l1, l2, beta_eps, max_iter: int,
                fam: Family, obj_eps, *, use_l1: bool):
    """The IRLS loop of GLM.java fitIRLSM: stops on the beta-epsilon
    (largest coefficient change), the objective-epsilon (relative change
    of the penalized objective) or ``max_iter``; each step is the best of
    {1, 1/2, ..., 1/128, 0} times the Newton step by penalized objective
    (the line search on quasi-separable data). One host sync a step."""
    dev = X1.device
    steps = torch.cat([2.0 ** -torch.arange(8, dtype=torch.float32,
                                            device=dev),
                       torch.zeros(1, dtype=torch.float32, device=dev)])
    beta_eps, obj_eps = _f32(beta_eps, dev), _f32(obj_eps, dev)
    delta, obj_prev, obj = (_f32(v, dev) for v in (1e30, -1e30, 1e30))
    for _ in range(max_iter):
        rel = torch.abs(obj_prev - obj) / torch.clamp_min(torch.abs(obj),
                                                          1e-10)
        if not bool((delta > beta_eps) & (rel > obj_eps)):
            break
        job_update(0.0, "IRLS iteration")
        full, _ = _irls_iter(X1, coef, y, w, off, l1, l2, fam,
                             use_l1=use_l1)
        cands = coef[None, :] + steps[:, None] * (full - coef)[None, :]
        mus = fam.linkinv(X1 @ cands.T + off[:, None])         # [N, 9]
        devs = torch.sum(w[:, None] * fam.deviance(y[:, None], mus), dim=0)
        c = cands[:, :-1]
        objs = devs + (l1 * torch.sum(torch.abs(c), dim=1)
                       + 0.5 * l2 * torch.sum(c * c, dim=1))
        k = first_argmin(objs).view(1)     # stays on the device
        new = cands.index_select(0, k)[0]
        delta = torch.max(torch.abs(new - coef))
        obj_prev, obj = obj, objs.index_select(0, k)[0]
        coef = new
    return coef


def _irls_solve_path(X1, coef, y, w, off, l1s, l2s, beta_eps, max_iter: int,
                     fam: Family, obj_eps, *, use_l1: bool):
    """The lambda path: one IRLS solve a lambda, each warm-started from
    the previous solution. Returns (last coefficients, [L, P+1] path)."""
    path = []
    for l1, l2 in zip(l1s, l2s):
        coef = _irls_solve(X1, coef, y, w, off, l1, l2, beta_eps, max_iter,
                           fam, obj_eps, use_l1=use_l1)
        path.append(coef)
    return coef, torch.stack(path)


def _irls_iter_cod(X1, coef, y, w, off, l1, l2, lo, hi, fam: Family):
    """One IRLS iteration solved by (box-constrained) cyclic coordinate
    descent (GLM.java:1495 fitCOD, the beta_constraints / non_negative
    projected path). Returns (coef, delta)."""
    _, z, w_irls = _working(fam, X1, coef, y, w, off)
    A, q = _normal_equations(X1, w_irls, z, w)
    new = coordinate_descent_quadratic(A, q, l1, l2,
                                       _penalize(X1.shape[1], X1.device),
                                       lower=lo, upper=hi, sweeps=COD_SWEEPS)
    return new, torch.max(torch.abs(new - coef))


def _grad_of(obj_fn, x64, dev):
    """(value, gradient) of ``obj_fn`` at the float64 host iterate taken
    as float32, by autograd."""
    c = torch.tensor(np.asarray(x64, np.float32), device=dev,
                     requires_grad=True)
    obj = obj_fn(c)
    g, = torch.autograd.grad(obj, c)
    return obj.detach(), g


def _glm_value_grad(coef, X1, y, w, off, l2, fam: Family):
    """Penalized deviance objective and gradient (GLMGradientTask)."""
    pen = _penalize(X1.shape[1], X1.device)
    nobs = torch.clamp_min(w.sum(), 1.0)

    def obj(c):
        mu = fam.linkinv(X1 @ c + off)
        dev = torch.sum(w * fam.deviance(y, mu)) / (2.0 * nobs)
        return dev + 0.5 * l2 * torch.sum(pen * c * c)

    return _grad_of(obj, coef, X1.device)


def _multinomial_value_grad(flat, X1, y_int, w, l2, K: int):
    Pp1 = X1.shape[1]
    pen = _penalize(Pp1, X1.device)
    Y = (y_int[:, None] == torch.arange(K, device=X1.device)[None, :]).to(
        torch.float32)
    nobs = torch.clamp_min(w.sum(), 1.0)

    def obj(fl):
        B = fl.reshape(Pp1, K)
        logp = torch.log_softmax(X1 @ B, dim=1)
        nll = -torch.sum(w[:, None] * Y * logp) / nobs
        return nll + 0.5 * l2 * torch.sum((pen[:, None] * B) ** 2)

    return _grad_of(obj, flat, X1.device)


def _multinomial_irls_solve(X1, B, y_int, w, l1, l2, beta_eps,
                            max_iter: int, *, K: int, use_l1: bool):
    """Multinomial IRLSM (GLM.java:1995): block-coordinate IRLS over the
    classes, one weighted least-squares solve a class a sweep (working
    weights p_c(1 - p_c), working response from the class margin), until
    the largest coefficient change is at most ``beta_eps``. One host sync
    a sweep."""
    dev = X1.device
    pen = _penalize(X1.shape[1], dev)
    beta_eps = _f32(beta_eps, dev)
    delta = torch.tensor(torch.inf, device=dev)
    for _ in range(max_iter):
        if not bool(delta > beta_eps):
            break
        job_update(0.0, "IRLS sweep")
        Bn = B
        for c in range(K):
            eta = X1 @ Bn
            pc = torch.softmax(eta, dim=1)[:, c]
            yc = (y_int == c).to(torch.float32)
            d = torch.clamp_min(pc * (1.0 - pc), 1e-10)
            A, q = _normal_equations(X1, w * d, eta[:, c] + (yc - pc) / d, w)
            if use_l1:
                bc = admm_l1_quadratic(A + l2 * torch.diag(pen), q, l1, pen)
            else:
                bc = cholesky_solve_regularized(A, q, l2, pen)
            Bn = Bn.clone()
            Bn[:, c] = bc
        delta = torch.max(torch.abs(Bn - B))
        B = Bn
    return B


def ordinal_probs(X1, beta, alphas):
    """Proportional-odds class probabilities [N, K]: differences of
    P(y <= k) = sigmoid(alpha_k - eta), bracketed by 0 and 1."""
    eta = X1[:, :-1] @ beta
    cum = torch.sigmoid(alphas[None, :] - eta[:, None])
    z = torch.zeros((eta.shape[0], 1), dtype=torch.float32,
                    device=eta.device)
    return torch.diff(torch.cat([z, cum, z + 1.0], dim=1), dim=1)


def _ordinal_value_grad(flat, X1, y_int, w, l2, K: int):
    """Proportional-odds (cumulative logit) NLL and gradient. Params:
    [beta (P), a0, d_1..d_{K-2}] with thresholds a0 + cumsum(exp(d))
    (ordered by construction)."""
    P = X1.shape[1] - 1            # the ones column is not used
    yi = y_int.long()[:, None]

    def obj(fl):
        beta = fl[:P]
        a0 = fl[P]
        alphas = torch.cat([a0[None], a0 + torch.cumsum(torch.exp(fl[P + 1:]),
                                                        dim=0)])
        pk = ordinal_probs(X1, beta, alphas).gather(1, yi)[:, 0]
        nll = -torch.sum(w * torch.log(torch.clamp(pk, 1e-9, 1.0))) \
            / torch.clamp_min(w.sum(), 1.0)
        return nll + 0.5 * l2 * torch.sum(beta * beta)

    return _grad_of(obj, flat, X1.device)


# ---- interactions (hex/DataInfo.java interactions) ----------------------
def _num_column(name: str, v: torch.Tensor, n: int) -> Column:
    """A numeric column from float32 values on the device, NaN = NA."""
    na = torch.isnan(v)
    host = fetch(v).astype(np.float64)[:n]
    return Column(name=name, type=T_NUM, data=torch.where(na, 0.0, v),
                  na_mask=na, nrows=n, host=host)


def _host_codes(col) -> np.ndarray:
    """int64 codes of a categorical column's rows, -1 at NA."""
    h = col.host_view()
    return np.where(np.isnan(h), -1, h).astype(np.int64)


def expand_interactions(frame: Frame, inter_cols: Sequence[str]) -> Frame:
    """The frame plus pairwise interaction columns among ``inter_cols``
    (InteractionWrappedVec semantics): num x num → the product ``a_b``;
    enum x enum → a combined factor ``a_b`` of the observed level pairs;
    enum x num → per-level masked numerics ``a.<level>_b``. The original
    columns are shared. Padding rows are NA in every new column (the
    reference's enum x num columns hold 0 there, which its design's mean
    and sigma count: the two agree on a frame the reference pads by no
    row)."""
    n = frame.nrows
    new_cols = [frame.col(c) for c in frame.names]
    for a, b in itertools.combinations(inter_cols, 2):
        ca, cb = frame.col(a), frame.col(b)
        if not ca.is_categorical and not cb.is_categorical:
            new_cols.append(_num_column(
                f"{a}_{b}", ca.numeric_view() * cb.numeric_view(), n))
        elif ca.is_categorical and cb.is_categorical:
            nb = len(cb.domain or [])
            ka, kb = _host_codes(ca), _host_codes(cb)
            combo = np.where((ka < 0) | (kb < 0), -1, ka * nb + kb)
            seen = np.unique(combo[combo >= 0])
            codes = np.where(combo >= 0, np.searchsorted(seen, combo), -1)
            dom = [f"{ca.domain[c // nb]}_{cb.domain[c % nb]}" for c in seen]
            new_cols.append(column_from_numpy(
                f"{a}_{b}", codes.astype(np.int32), frame.nrows_padded,
                frame.device, domain=dom))
        else:
            cat, num = (ca, cb) if ca.is_categorical else (cb, ca)
            cname, nname = (a, b) if ca.is_categorical else (b, a)
            vnum = num.numeric_view()
            codes = cat.data.long()
            for li, lvl in enumerate(cat.domain or []):
                v = torch.where((codes == li) & ~cat.na_mask, vnum, 0.0)
                new_cols.append(_num_column(f"{cname}.{lvl}_{nname}", v, n))
    return Frame(new_cols, n, frame.device, npad=frame.nrows_padded,
                 block=frame.block)


def _parse_interactions(inter) -> List[str]:
    if isinstance(inter, str):
        return [c.strip().strip('"') for c in inter.strip("[]").split(",")]
    return list(inter)


def _host(c) -> np.ndarray:
    return fetch(c) if isinstance(c, torch.Tensor) else np.asarray(c)


def _coef_on(c, dev) -> torch.Tensor:
    """A warm start as float32 on ``dev`` (a tensor stays on the card)."""
    if isinstance(c, torch.Tensor):
        return c.to(dev, torch.float32)
    return torch.from_numpy(np.array(c, np.float32)).to(dev)


class GLMModel(Model):
    algo = "glm"

    def __init__(self, params, output, coef: np.ndarray, family: Family,
                 di_stats: dict, features: List[str],
                 coef_multinomial: Optional[np.ndarray] = None):
        super().__init__(params, output)
        self.coef = coef                       # [P+1] (last = intercept)
        self.coef_multinomial = coef_multinomial  # [P+1, K] or None
        self.family = family
        self.di_stats = di_stats
        self.features = features

    def _design(self, frame: Frame) -> torch.Tensor:
        inter = self.params.get("interactions")
        if inter:
            frame = expand_interactions(frame, _parse_interactions(inter))
        return build_datainfo(
            frame, self.features,
            standardize=self.params.get("standardize", True),
            use_all_factor_levels=self.params.get("use_all_factor_levels",
                                                  False),
            stats_override=self.di_stats).X1

    def _frame_offset(self, frame: Frame):
        oc = self.params.get("offset_column")
        if not oc or oc not in frame:
            return None
        ov = frame.col(oc).numeric_view()
        return torch.where(torch.isnan(ov), 0.0, ov)

    def _coef_t(self, X1, coef=None):
        return torch.from_numpy(np.array(
            self.coef if coef is None else coef, np.float32)).to(X1.device)

    def _eta(self, frame: Frame, X1=None):
        """Margins: [Npad], or [Npad, K] for multinomial. The offset is
        not applied to a multinomial model: a per-row constant on every
        class margin cancels in the softmax (GLM.java:978)."""
        X1 = self._design(frame) if X1 is None else X1
        with exact_f32():
            if self.coef_multinomial is not None:
                return X1 @ self._coef_t(X1, self.coef_multinomial)
            eta = X1 @ self._coef_t(X1)
        off = self._frame_offset(frame)
        return eta if off is None else eta + off

    def _score_dev(self, frame: Frame) -> torch.Tensor:
        """The device scores: [Npad, K] class probabilities (ordinal and
        multinomial, offset ignored) or mu."""
        if self.output.get("family") == "ordinal":
            X1 = self._design(frame)
            P = X1.shape[1] - 1
            return ordinal_probs(
                X1, self._coef_t(X1, self.coef[:P]),
                self._coef_t(X1, self.output["ordinal_alphas"]))
        if self.coef_multinomial is not None:
            return torch.softmax(self._eta(frame), dim=1)
        return self.family.linkinv(self._eta(frame))

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        require_local(frame, self.algo)
        n = frame.nrows
        out = fetch(self._score_dev(frame))[:n]
        if out.ndim == 2:
            cols = {"predict": out.argmax(axis=1).astype(np.int32)}
            for k in range(out.shape[1]):
                cols[f"p{k}"] = out[:, k]
            return cols
        if self.output["category"] == ModelCategory.BINOMIAL:
            t = self.output.get("default_threshold", 0.5)
            return {"predict": (out >= t).astype(np.int32),
                    "p0": 1.0 - out, "p1": out}
        return {"predict": out}

    def model_performance(self, frame: Frame, mask_weights=None):
        """``mask_weights``: the CV fast path's holdout rows on the
        parent frame (ModelBuilder)."""
        y = self.output["response"]
        cat = self.output["category"]
        eta = self._eta(frame)
        w = frame.valid_weights()
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wc = frame.col(wc_name).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        w = masked_weights(w, mask_weights)
        if cat in (ModelCategory.BINOMIAL, ModelCategory.MULTINOMIAL):
            yv = frame.local_rows(adapt_domain(frame.col(y),
                                               self.output["domain"]), -1)
            w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(
                w.device)
            yt = torch.from_numpy(np.maximum(yv, 0)).to(w.device)
            if cat == ModelCategory.BINOMIAL:
                return mm.binomial_metrics(self.family.linkinv(eta),
                                           yt.to(torch.float32), w)
            return mm.multinomial_metrics(torch.softmax(eta, dim=1), yt, w,
                                          domain=self.output["domain"])
        yv = frame.col(y).numeric_view()
        w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
        yv = torch.where(torch.isnan(yv), 0.0, yv)
        return mm.regression_metrics(self.family.linkinv(eta), yv, w,
                                     deviance_fn=self.family.deviance)

    @property
    def coefficients(self) -> Dict[str, float]:
        """RAW-scale coefficients (h2o-py model.coef()): a standardized
        fit's coefficients de-standardized; multinomial and ordinal keep
        model space (ordinal's trailing coefficient is a placeholder, its
        thresholds are ``output['ordinal_alphas']``)."""
        names = self.output["coef_names"] + ["Intercept"]
        if self.coef_multinomial is not None:
            K = self.coef_multinomial.shape[1]
            return {f"{nm}_class{k}": float(self.coef_multinomial[i, k])
                    for i, nm in enumerate(names) for k in range(K)}
        coefs = np.asarray(self.coef, np.float64)
        if self.output.get("standardized") and \
                self.output.get("family") != "ordinal":
            coefs = destandardize_coefs(coefs, self.output.get("coef_means"),
                                        self.output.get("coef_sds"))
        return {nm: float(c) for nm, c in zip(names, coefs)}


def destandardize_coefs(coefs: np.ndarray, mus, sds) -> np.ndarray:
    """Standardized-design coefficients → raw scale: raw_j = std_j/σ_j,
    the intercept shifted by Σ std_j·μ_j/σ_j."""
    p = len(coefs) - 1
    mus = np.asarray(mus if mus is not None else [0.0] * p, np.float64)
    sds = np.asarray(sds if sds is not None else [1.0] * p, np.float64)
    raw = np.asarray(coefs, np.float64).copy()
    raw[:-1] = coefs[:-1] / sds
    raw[-1] = coefs[-1] - float(np.sum(coefs[:-1] * mus / sds))
    return raw


class GLMEstimator(ModelBuilder):
    """h2o-py H2OGeneralizedLinearEstimator surface. ``Lambda`` /
    ``lambda`` alias ``lambda_`` and ``tweedie_variance_power`` aliases
    ``tweedie_power``; ``intercept`` and ``missing_values_handling`` are
    accepted and inert, as in the reference (mean imputation only)."""

    algo = "glm"
    label = "GLM"
    cv_fold_masking = True   # ml/cv.py fast path: folds = masked weights

    DEFAULTS = dict(
        family="auto", link=None, solver="auto", alpha=0.5,
        lambda_=None, lambda_search=False, nlambdas=30,
        lambda_min_ratio=1e-4, standardize=True,
        use_all_factor_levels=False, max_iterations=50,
        beta_epsilon=1e-4, objective_epsilon=-1,
        tweedie_power=1.5, theta=1e-5, seed=-1, nfolds=0,
        fold_assignment="auto",
        weights_column=None, fold_column=None, offset_column=None,
        ignored_columns=None,
        missing_values_handling="mean_imputation",
        compute_p_values=False, intercept=True,
        beta_constraints=None, non_negative=False, interactions=None,
        keep_cross_validation_models=True,
        keep_cross_validation_predictions=False,
        keep_cross_validation_fold_assignment=False,
    )
    PORTED = frozenset(DEFAULTS)

    def __init__(self, **params):
        for alias in ("Lambda", "lambda"):
            if alias in params:
                params["lambda_"] = params.pop(alias)
        if "tweedie_variance_power" in params:
            params["tweedie_power"] = params.pop("tweedie_variance_power")
        super().__init__(**params)

    # ---- solvers -----------------------------------------------------
    def _objective_eps(self) -> float:
        """GLM.java:1176: -1 → 1e-4 under lambda search or any nonzero
        lambda, 1e-6 for unpenalized fits."""
        oe = self.params.get("objective_epsilon")
        if oe is not None and float(oe) > 0:
            return float(oe)
        lam = self.params.get("lambda_")
        lam0 = (lam[0] if isinstance(lam, (list, tuple)) and lam
                else (lam or 0.0))
        if self.params.get("lambda_search") or float(lam0) != 0.0:
            return 1e-4
        return 1e-6

    def _fit_irlsm(self, X1, yv, w, fam, l1, l2, coef0, max_iter: int,
                   beta_eps: float, off):
        dev = X1.device
        coef = _coef_on(coef0, dev)
        return _irls_solve(X1, coef, yv, w, off, _f32(l1, dev),
                           _f32(l2, dev), beta_eps, max_iter, fam,
                           self._objective_eps(), use_l1=l1 > 0)

    def _fit_cod(self, X1, yv, w, fam, l1, l2, coef0, max_iter: int,
                 beta_eps: float, bounds, off) -> np.ndarray:
        """IRLS outer loop with a COD (box-constrained) inner solve."""
        dev = X1.device
        lo, hi = (None, None) if bounds is None else (
            torch.as_tensor(np.asarray(b, np.float32)).to(dev)
            for b in bounds)
        coef = _coef_on(coef0, dev)
        for _ in range(max_iter):
            job_update(0.0, "IRLS-COD iteration")
            coef, delta = _irls_iter_cod(X1, coef, yv, w, off, _f32(l1, dev),
                                         _f32(l2, dev), lo, hi, fam)
            if float(delta) < beta_eps:
                break
        return fetch(coef)

    def _bounds_of(self, p, coef_names) -> Optional[tuple]:
        """Lower/upper coefficient bounds from ``beta_constraints`` (a
        Frame with names / lower_bounds / upper_bounds columns, or a dict
        name → (lower, upper)) and ``non_negative``."""
        Pp1 = len(coef_names) + 1
        lo = np.full(Pp1, -np.inf)
        hi = np.full(Pp1, np.inf)
        if p.get("non_negative"):
            lo[:-1] = 0.0
        bc = p.get("beta_constraints")
        if bc is not None:
            if isinstance(bc, str):
                bc = resolve_frame(bc, "beta_constraints")
            rows: Dict[str, tuple] = {}
            if isinstance(bc, Frame):
                nm_col = bc.col("names")
                if nm_col.is_categorical and nm_col.domain:
                    labels = [nm_col.domain[int(c)] if c >= 0 else None
                              for c in _host_codes(nm_col)]
                else:
                    labels = [str(v) for v in nm_col.to_numpy()]
                lob = (bc.col("lower_bounds").to_numpy()
                       if "lower_bounds" in bc else [None] * bc.nrows)
                upb = (bc.col("upper_bounds").to_numpy()
                       if "upper_bounds" in bc else [None] * bc.nrows)
                for i, nm in enumerate(labels):
                    rows[str(nm)] = (lob[i], upb[i])
            else:
                rows = {k: tuple(v) for k, v in bc.items()}
            for j, nm in enumerate(coef_names):
                if nm in rows:
                    l_, u_ = rows[nm]
                    if l_ is not None and not (isinstance(l_, float)
                                               and np.isnan(l_)):
                        lo[j] = float(l_)
                    if u_ is not None and not (isinstance(u_, float)
                                               and np.isnan(u_)):
                        hi[j] = float(u_)
        if not (np.isfinite(lo).any() or np.isfinite(hi).any()):
            return None
        return lo, hi

    def _fit_lbfgs(self, X1, yv, w, fam, l2, coef0, max_iter: int,
                   off) -> np.ndarray:
        l2d = _f32(l2, X1.device)
        coef, _, _ = lbfgs(lambda c: _glm_value_grad(c, X1, yv, w, off, l2d,
                                                     fam),
                           _host(coef0), max_iter=max_iter)
        return coef

    def _fit_multinomial(self, X1, y_int, w, K: int, l2: float,
                         max_iter: int, solver: str, l1: float):
        dev = X1.device
        if solver in ("irlsm", "coordinate_descent",
                      "coordinate_descent_naive"):
            B0 = torch.zeros((X1.shape[1], K), dtype=torch.float32,
                             device=dev)
            return fetch(_multinomial_irls_solve(
                X1, B0, y_int, w, _f32(l1, dev), _f32(l2, dev), 1e-5,
                max_iter, K=K, use_l1=l1 > 0))
        l2d = _f32(l2, dev)
        sol, _, _ = lbfgs(lambda c: _multinomial_value_grad(c, X1, y_int, w,
                                                            l2d, K),
                          np.zeros(X1.shape[1] * K), max_iter=max_iter)
        return sol.reshape(X1.shape[1], K)

    # ---- training ----------------------------------------------------
    def _resolve_family(self, category: str) -> str:
        f = str(self.params["family"]).lower()
        if f != "auto":
            return f
        return {"Binomial": "binomial", "Multinomial": "multinomial",
                "Regression": "gaussian"}[category]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        with exact_f32():
            return self._fit_glm(frame, list(x), y)

    def _class_response(self, frame: Frame, rc, w):
        """(class codes on the device, w with NA responses at 0)."""
        host = rc.host_view()
        dev = w.device
        yv = frame.local_rows(np.nan_to_num(host).astype(np.int64), 0)
        ok = frame.local_rows((~np.isnan(host)).astype(np.float32), 0)
        return (torch.from_numpy(yv).to(dev),
                w * torch.from_numpy(ok).to(dev))

    def _fit_glm(self, frame: Frame, x: List[str], y: str) -> Model:
        p = self.params
        dev = frame.device
        category = infer_category(frame, y)
        fam_name = self._resolve_family(category)
        fam = Family(fam_name, float(p["tweedie_power"]), p["link"],
                     theta=float(p.get("theta") or 1e-5)) \
            if fam_name not in ("multinomial", "ordinal") else None

        di_frame = frame
        if p.get("interactions"):
            p["interactions"] = _parse_interactions(p["interactions"])
            di_frame = expand_interactions(frame, p["interactions"])
            x = x + [c for c in di_frame.names if c not in frame.names]
        di = build_datainfo(di_frame, x, standardize=bool(p["standardize"]),
                            use_all_factor_levels=bool(
                                p["use_all_factor_levels"]))
        X1 = di.X1
        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        # CV fast path: the standardization stats stay full-frame
        w = self._cv_masked_weights(w, frame)

        off = None
        if p.get("offset_column") and p["offset_column"] in frame:
            if fam_name == "multinomial":
                warnings.warn("offset_column has no effect on multinomial "
                              "and will be ignored")
            else:
                ov = frame.col(p["offset_column"]).numeric_view()
                off = torch.where(torch.isnan(ov), 0.0, ov)
        off_or0 = off if off is not None else torch.zeros(
            (X1.shape[0],), dtype=torch.float32, device=dev)

        rc = frame.col(y)
        cmus, csds = coef_stats(di)
        output = {"category": category, "response": y, "names": list(x),
                  "coef_names": di.coef_names, "domain": rc.domain,
                  "coef_means": cmus.tolist(), "coef_sds": csds.tolist(),
                  "standardized": bool(p["standardize"]),
                  "nclasses": rc.cardinality if rc.is_categorical else 1}

        if fam_name == "ordinal":
            return self._fit_ordinal(frame, x, rc, X1, w, di, output)
        if category == ModelCategory.MULTINOMIAL:
            return self._fit_multinomial_model(frame, x, rc, X1, w, di,
                                               output)

        # single-coefficient-vector families
        if category == ModelCategory.BINOMIAL:
            yraw = frame.local_rows(adapt_domain(rc, rc.domain), -1)
            yv = np.maximum(yraw, 0).astype(np.float32)
            wna = (yraw >= 0).astype(np.float32)
        else:
            yn = frame.local_rows(rc.host_view(), np.nan)
            wna = (~np.isnan(yn)).astype(np.float32)
            yv = np.nan_to_num(yn).astype(np.float32)
        w = w * torch.from_numpy(wna).to(dev)
        y_dev = torch.from_numpy(yv).to(dev)
        nobs = float(w.sum())

        alpha = float(p["alpha"] if p["alpha"] is not None else 0.5)
        lambdas = _lambda_path(p, X1, y_dev, w, nobs, alpha)
        if p.get("compute_p_values") and any(lam != 0.0 for lam in lambdas):
            raise ValueError("compute_p_values requires no regularization "
                             "(lambda = 0)")
        solver = str(p["solver"]).lower()
        bounds = self._bounds_of(p, di.coef_names)
        if solver == "auto":
            solver = "coordinate_descent" if bounds is not None else "irlsm"
        elif bounds is not None:
            solver = "coordinate_descent"   # the projected COD path

        coef = np.zeros(X1.shape[1])
        coef_path = None
        max_iter = int(p["max_iterations"])
        beta_eps = float(p["beta_epsilon"])
        if len(lambdas) > 1 and bounds is None and solver not in (
                "coordinate_descent", "coordinate_descent_naive",
                "l_bfgs", "lbfgs"):
            # the whole path warm-started, ADMM throughout when alpha > 0
            coef, coef_path = _irls_solve_path(
                X1, torch.zeros((X1.shape[1],), dtype=torch.float32,
                                device=dev), y_dev, w, off_or0,
                [_f32(lam * alpha, dev) for lam in lambdas],
                [_f32(lam * (1.0 - alpha), dev) for lam in lambdas],
                beta_eps, max_iter, fam, self._objective_eps(),
                use_l1=alpha > 0)
        else:
            for lam in lambdas:
                l1, l2 = lam * alpha, lam * (1.0 - alpha)
                if solver in ("coordinate_descent",
                              "coordinate_descent_naive"):
                    coef = self._fit_cod(X1, y_dev, w, fam, l1, l2, coef,
                                         max_iter, beta_eps, bounds, off_or0)
                elif solver in ("l_bfgs", "lbfgs") and l1 == 0:
                    coef = self._fit_lbfgs(X1, y_dev, w, fam, l2, coef,
                                           max_iter, off_or0)
                else:
                    coef = self._fit_irlsm(X1, y_dev, w, fam, l1, l2, coef,
                                           max_iter, beta_eps, off_or0)
        coef = _host(coef)

        output["lambda_best"] = float(lambdas[-1])
        # a CV lambda search picks its lambda by summed holdout deviance
        # over this path (ml/cv.py)
        sel_lambda = p.get("_cv_selected_lambda")
        if sel_lambda is not None and coef_path is not None:
            li = int(np.argmin(np.abs(np.asarray(lambdas) - sel_lambda)))
            coef = fetch(coef_path[li])
            output["lambda_best"] = float(lambdas[li])

        coef_t = torch.as_tensor(np.asarray(coef, np.float32)).to(dev)
        if p.get("compute_p_values"):
            output["coefficients_table"] = _p_values_table(
                X1, y_dev, w, coef_t, fam, di.coef_names + ["Intercept"],
                nobs, off=off_or0)
        model = GLMModel(p, output, coef, fam, stats_of(di), list(x))
        if coef_path is not None:
            model._coef_path = fetch(coef_path)       # [L, P+1]
            model._lambda_path_vals = list(lambdas)
        mu = fam.linkinv(X1 @ coef_t + off_or0)
        if category == ModelCategory.BINOMIAL:
            model.training_metrics = mm.binomial_metrics(mu, y_dev, w)
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        else:
            model.training_metrics = mm.regression_metrics(
                mu, y_dev, w, deviance_fn=fam.deviance)
        return model

    def _fit_ordinal(self, frame, x, rc, X1, w, di, output):
        p = self.params
        if not rc.is_categorical:
            raise ValueError("ordinal family requires a categorical "
                             "response (ordered levels)")
        K = rc.cardinality
        y_dev, w = self._class_response(frame, rc, w)
        l2d = _f32(_l2_of(p), X1.device)
        P = X1.shape[1] - 1
        x0 = np.zeros(P + K - 1)
        x0[P + 1:] = np.log(0.5)       # small increasing gaps
        sol, _, _ = lbfgs(lambda c: _ordinal_value_grad(c, X1, y_dev, w,
                                                        l2d, K),
                          x0, max_iter=int(p["max_iterations"]) * 4)
        a0 = float(sol[P])
        alphas = np.concatenate([[a0], a0 + np.cumsum(np.exp(sol[P + 1:]))])
        output.update(category=ORDINAL, family="ordinal",
                      ordinal_alphas=alphas.tolist())
        model = GLMModel(p, output, np.concatenate([sol[:P], [0.0]]),
                         Family("binomial"), stats_of(di), list(x))
        probs = ordinal_probs(X1, model._coef_t(X1, sol[:P]),
                              model._coef_t(X1, alphas))
        model.training_metrics = mm.multinomial_metrics(
            probs, y_dev, w, domain=rc.domain)
        model.training_metrics.kind = ORDINAL
        return model

    def _fit_multinomial_model(self, frame, x, rc, X1, w, di, output):
        p = self.params
        if p.get("compute_p_values"):
            raise ValueError("compute_p_values is not supported for "
                             "multinomial GLM (reference restriction)")
        K = rc.cardinality
        y_dev, w = self._class_response(frame, rc, w)
        msolver = str(p["solver"]).lower()
        if msolver == "auto":
            # K P x P Grams a sweep: wide designs go to L-BFGS (GLM.java
            # defaultSolver)
            msolver = "irlsm" if X1.shape[1] <= 2000 else "l_bfgs"
        lam = p.get("lambda_") or 0.0
        if isinstance(lam, (list, tuple)):
            lam = lam[0] if lam else 0.0
        alpha = float(p["alpha"] if p["alpha"] is not None else 0.5)
        B = self._fit_multinomial(X1, y_dev, w, K, _l2_of(p),
                                  int(p["max_iterations"]), solver=msolver,
                                  l1=alpha * float(lam))
        model = GLMModel(p, output, B[:, 0], Family("binomial"),
                         stats_of(di), list(x), coef_multinomial=B)
        probs = torch.softmax(X1 @ model._coef_t(X1, B), dim=1)
        model.training_metrics = mm.multinomial_metrics(
            probs, y_dev, w, domain=rc.domain)
        return model


def _l2_of(p) -> float:
    lam = p["lambda_"]
    if lam is None:
        return 0.0
    lam = lam[0] if isinstance(lam, (list, tuple)) else lam
    return float(lam) * (1.0 - float(p["alpha"] or 0.0))


def _lambda_path(p, X1, y, w, nobs: float, alpha: float) -> List[float]:
    """Regularization path (GLM.java lambda search): nlambdas values
    log-spaced from lambda_max, the smallest lambda with every penalized
    coefficient 0, down to lambda_max · lambda_min_ratio."""
    if p.get("_lambda_path_override"):
        # CV fold fits walk the main model's full-frame path, so their
        # per-lambda holdout deviances align index-wise
        return list(p["_lambda_path_override"])
    lam = p["lambda_"]
    if not p["lambda_search"]:
        if lam is None:
            return [0.0]
        return list(lam) if isinstance(lam, (list, tuple)) else [float(lam)]
    ybar = float(torch.sum(w * y) / torch.clamp_min(torch.sum(w), 1e-12))
    xty = torch.abs((X1 * w[:, None]).T @ (y - ybar))[:-1]
    lam_max = float(torch.max(xty)) / (nobs * max(alpha, 1e-3))
    lmr = float(p["lambda_min_ratio"])
    if lmr <= 0:            # wire default -1 = auto
        lmr = 1e-4
    n = int(p["nlambdas"])
    if n <= 0:              # wire default -1 = auto → 100 lambdas
        n = 100
    return list(np.exp(np.linspace(np.log(lam_max), np.log(lam_max * lmr),
                                   n)))


def _p_values_table(X1, y, w, coef, fam: Family, names, nobs: float,
                    off=None):
    """Wald rows (name, coefficient, std_error, z_value, p_value) from the
    Fisher information X'WX at the fitted coefficients, W =
    (dmu/deta)² / Var(mu). Dispersion: the moment estimate for gaussian
    (t distribution), 1 for binomial and poisson, the Pearson estimate
    otherwise (normal). scipy's distributions on the host."""
    from scipy import stats as st
    eta = X1 @ coef if off is None else X1 @ coef + off
    mu = fam.linkinv(eta)
    dmu = fam.dmu_deta(eta, mu)
    wi = w * dmu * dmu / torch.clamp_min(fam.variance(mu), 1e-12)
    info = fetch((X1 * wi[:, None]).T @ X1).astype(np.float64)
    P = info.shape[0]
    try:
        cov = np.linalg.inv(info + 1e-10 * np.eye(P))
    except np.linalg.LinAlgError:
        cov = np.linalg.pinv(info)
    dof = max(nobs - P, 1.0)
    wh = fetch(w).astype(np.float64)
    resid = fetch(y - mu).astype(np.float64)
    if fam.name == "gaussian":
        dispersion = float((wh * resid ** 2).sum() / dof)
    elif fam.name in ("binomial", "poisson"):
        dispersion = 1.0
    else:
        var = np.maximum(fetch(fam.variance(mu)).astype(np.float64), 1e-12)
        dispersion = float((wh * resid ** 2 / var).sum() / dof)
    se = np.sqrt(np.maximum(np.diag(cov) * dispersion, 0.0))
    ch = fetch(coef).astype(np.float64)
    z = np.where(se > 0, ch / np.maximum(se, 1e-300), np.inf)
    if fam.name == "gaussian":
        pv = 2.0 * st.t.sf(np.abs(z), df=dof)
    else:
        pv = 2.0 * st.norm.sf(np.abs(z))
    return [{"name": nm, "coefficient": float(c), "std_error": float(s),
             "z_value": float(zz), "p_value": float(pp)}
            for nm, c, s, zz, pp in zip(names, ch, se, z, pv)]


def fit_glm_batched(builder_cls, params_list, frame: Frame, y=None, x=None,
                    validation_frame=None):
    """The reference trains a grid bucket's (alpha, lambda) product as one
    vmapped IRLS program; here it waits for ``parallel/model_batch.py``
    (the grid walks its combos one after another meanwhile)."""
    raise NotImplementedError(
        "fit_glm_batched is not ported yet: it waits for "
        "parallel/model_batch.py (ROADMAP A #9′)")
