"""CoxPH — Cox proportional hazards with Efron or Breslow ties.

Reference: h2o3_tpu/models/coxph.py (hex/coxph/CoxPH.java): counting
process (start, stop] input, strata, Efron (default) or Breslow ties,
Newton iterations with step halving, standard errors from the inverse
Hessian, concordance.

The risk-set structure (sort orders, tie groups, each event's rank in
its group, the gather positions of every group in the two sorted
orders) depends only on the times, so it is computed once on the host
in float64 numpy (``_risk_structure``) and is the reference's EXACTLY.
The reference finds each group's positions with a search over its whole
stratum, group by group, which is quadratic; here one ``searchsorted``
a stratum places all of its groups.

On the device a risk-set sum R_g = Σ r_j over {start_j < t_g <= stop_j}
in the stratum, r = w·exp(eta), is the difference of two segmented
prefix sums over the rows sorted by stop and by start times, and an
Efron tie sum T_g the difference of a prefix sum over the event rows in
group order. The prefix sums are float64 and built from block-triangular
matrix products (``prefix_sums``): the same order of adds on every run,
on the card as on the CPU (the card's ``cumsum`` adds in a varying
order), and a float32 difference of two sums of a million rows would
keep few digits. The objective is the reference's weighted Efron form
Σ w·ev·(eta − log(R_g − (k/d_g) T_g)); its gradient and Hessian are in
closed form from the same sums of r·x and r·x·xᵀ (the partial
likelihood does not move when a design column shifts, so the columns
are centred on their weighted means first, which keeps the Hessian's
variance terms from cancelling). Newton: solve(H + 1e-6·I, g), up to 10
halvings of the step, the ``lre_min`` stop; one host fetch an objective
value, as in the reference.

Not ported: a partitioned frame (ROADMAP A #12′);
``nfolds`` and ``fold_column`` raise (the reference's cross-validation
of CoxPH fails).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.datainfo import build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import Model, ModelBuilder, require_local
from h2o3_tpu_torch.ops.gram import exact_f32

SCAN_BLOCK = 1024


def _block_starts(s: np.ndarray) -> np.ndarray:
    return np.r_[True, s[1:] != s[:-1]] if len(s) else np.zeros(0, bool)


def _positions(key_sorted: np.ndarray, s_sorted: np.ndarray,
               grp_s: np.ndarray, grp_t: np.ndarray):
    """For each group (stratum grp_s, time grp_t): the first position of
    its stratum in the sorted order, and the count of the stratum's rows
    with key >= grp_t (``key_sorted`` descends within each stratum)."""
    first = np.flatnonzero(_block_starts(s_sorted))
    bounds = np.r_[first, len(s_sorted)]
    strata = s_sorted[first]
    b0 = np.zeros(len(grp_s), np.int64)
    cnt = np.zeros(len(grp_s), np.int64)
    present = np.zeros(len(grp_s), bool)
    # groups come sorted by stratum: one search a stratum
    gb = np.flatnonzero(_block_starts(grp_s))
    for lo, hi in zip(gb, np.r_[gb[1:], len(grp_s)]):
        i = np.searchsorted(strata, grp_s[lo])
        if i == len(strata) or strata[i] != grp_s[lo]:
            continue
        a, b = bounds[i], bounds[i + 1]
        b0[lo:hi] = a
        cnt[lo:hi] = np.searchsorted(-key_sorted[a:b], -grp_t[lo:hi],
                                     side="right")
        present[lo:hi] = True
    return b0, cnt, present


def _risk_structure(start: np.ndarray, stop: np.ndarray, event: np.ndarray,
                    strata: np.ndarray) -> dict:
    """The index structure of the partial likelihood, from the times
    only (host numpy). The reference's arrays, plus the event rows in
    group order (``ev_sorted``) and the first position of each group
    among them (``grp_first``)."""
    n = len(stop)
    ord_stop = np.lexsort((-stop, strata))
    ord_start = np.lexsort((-start, strata))
    ev = np.flatnonzero(event > 0)
    if len(ev) == 0:
        raise ValueError("CoxPH requires at least one event")
    ev_sorted = ev[np.lexsort((stop[ev], strata[ev]))]
    t_ev, s_ev = stop[ev_sorted], strata[ev_sorted]
    new_grp = np.r_[True, (t_ev[1:] != t_ev[:-1]) | (s_ev[1:] != s_ev[:-1])]
    gid_sorted = np.cumsum(new_grp) - 1
    G = int(gid_sorted[-1]) + 1
    grp_first = np.flatnonzero(new_grp)
    rank_sorted = np.arange(len(ev_sorted)) - grp_first[gid_sorted]
    d_g = np.bincount(gid_sorted, minlength=G).astype(np.float64)
    gid_row = np.zeros(n, np.int32)
    rank_row = np.zeros(n, np.int32)
    gid_row[ev_sorted] = gid_sorted
    rank_row[ev_sorted] = rank_sorted

    grp_t, grp_s = t_ev[new_grp], s_ev[new_grp]
    b0_stop, cnt, _ = _positions(stop[ord_stop], strata[ord_stop],
                                 grp_s, grp_t)
    pos_stop = np.where(cnt > 0, b0_stop + cnt - 1, -1)
    b0_start, cnt1, present = _positions(start[ord_start],
                                         strata[ord_start], grp_s, grp_t)
    pos_start = np.where(present & (cnt1 > 0), b0_start + cnt1 - 1, -1)
    return dict(
        ord_stop=ord_stop.astype(np.int32),
        ord_start=ord_start.astype(np.int32),
        gid_row=gid_row, rank_row=rank_row,
        d_g=d_g.astype(np.float32), n_groups=G,
        pos_stop=pos_stop.astype(np.int32),
        pos_start=pos_start.astype(np.int32),
        blk0_stop=b0_stop.astype(np.int32),
        blk0_start=b0_start.astype(np.int32),
        ev_sorted=ev_sorted, grp_first=grp_first)


def _lower_ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((n, n), dtype=like.dtype, device=like.device).tril_()


def prefix_sums(v: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of the rows of v [N, K], as products of
    SCAN_BLOCK-row blocks with a lower-triangular matrix of ones plus
    the prefix sums of the block totals: a fixed order of adds."""
    N, K = v.shape
    T = SCAN_BLOCK
    if N <= T:
        return _lower_ones(N, v) @ v
    M = -(-N // T)
    blocks = torch.nn.functional.pad(v, (0, 0, 0, M * T - N)).view(M, T, K)
    inner = torch.matmul(_lower_ones(T, v), blocks)
    head = prefix_sums(inner[:, -1, :])
    head = torch.cat([torch.zeros_like(head[:1]), head[:-1]])
    return (inner + head[:, None, :]).reshape(M * T, K)[:N]


def _seg_prefix(c, pos, blk0):
    """Σ of the rows of the sorted prefix sums ``c`` from the group's
    stratum start to its position (0 where it has none)."""
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    tot = torch.where((pos >= 0)[:, None], c[pos.clamp_min(0)], zero)
    head = torch.where(((blk0 > 0) & (pos >= 0))[:, None],
                       c[(blk0 - 1).clamp_min(0)], zero)
    return tot - head


class _CoxData:
    """The fit's device tensors over the logical rows."""

    def __init__(self, X, w, ev, rs, efron: bool):
        dev = X.device
        self.X = X                                   # [n, P] float32
        self.w = w
        self.P = X.shape[1]
        idx = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a).astype(np.int64)).to(dev)
        self.ord_stop, self.ord_start = idx(rs["ord_stop"]), \
            idx(rs["ord_start"])
        self.pos_stop, self.pos_start = idx(rs["pos_stop"]), \
            idx(rs["pos_start"])
        self.blk0_stop, self.blk0_start = idx(rs["blk0_stop"]), \
            idx(rs["blk0_start"])
        self.has_start = bool((rs["pos_start"] >= 0).any())
        ev_sorted = rs["ev_sorted"]
        self.ev_sorted = idx(ev_sorted)
        gid = rs["gid_row"][ev_sorted]
        self.gid = idx(gid)
        first = rs["grp_first"]
        self.last = idx(np.r_[first[1:], len(ev_sorted)] - 1)
        self.before = idx(first - 1)
        self.frac = torch.from_numpy(
            (rs["rank_row"][ev_sorted] / np.maximum(rs["d_g"][gid], 1.0))
            .astype(np.float64) if efron else
            np.zeros(len(ev_sorted))).to(dev)
        evf = torch.from_numpy(ev.astype(np.float32)).to(dev)
        self.evf_e = evf[self.ev_sorted].to(torch.float64)
        self.a_e = (w * evf)[self.ev_sorted].to(torch.float64)
        self.iu, self.ju = (t.to(dev) for t in torch.triu_indices(
            self.P, self.P))

    def eta(self, beta):
        with exact_f32():
            eta = self.X @ beta
        wsum = torch.clamp_min(self.w.sum(), 1e-12)
        return eta - (self.w * eta).sum() / wsum

    def terms(self, beta, order: int):
        """(−loglik, gradient, Hessian) of the negative partial
        log-likelihood at ``beta``, to the given order (0, 1 or 2)."""
        eta = self.eta(beta)
        r = (self.w * torch.exp(eta)).to(torch.float64)
        cols = [r[:, None]]
        if order >= 1:
            X = self.X.to(torch.float64)
            cols.append(r[:, None] * X)
        if order >= 2:
            cols.append(r[:, None] * (X[:, self.iu] * X[:, self.ju]))
        V = torch.cat(cols, 1)
        R = _seg_prefix(prefix_sums(V[self.ord_stop]), self.pos_stop,
                        self.blk0_stop)
        if self.has_start:
            R = R - _seg_prefix(prefix_sums(V[self.ord_start]),
                                self.pos_start, self.blk0_start)
        ce = prefix_sums(V[self.ev_sorted] * self.evf_e[:, None])
        Tg = ce[self.last] - torch.where(
            (self.before >= 0)[:, None], ce[self.before.clamp_min(0)],
            torch.zeros((), dtype=ce.dtype, device=ce.device))
        # per event row, in group order
        D = R[self.gid] - self.frac[:, None] * Tg[self.gid]
        denom = torch.clamp_min(D[:, 0], 1e-30)
        a = self.a_e
        ll = (a * (eta[self.ev_sorted].to(torch.float64)
                   - torch.log(denom))).sum()
        if order == 0:
            return -ll, None, None
        P = self.P
        m = D[:, 1:1 + P] / denom[:, None]
        g = -(a[:, None] * (X[self.ev_sorted] - m)).sum(0)
        if order == 1:
            return -ll, g, None
        s2 = D[:, 1 + P:] / denom[:, None] - m[:, self.iu] * m[:, self.ju]
        h = (a[:, None] * s2).sum(0)
        H = torch.zeros((P, P), dtype=h.dtype, device=h.device)
        H[self.iu, self.ju] = h
        H[self.ju, self.iu] = h
        return -ll, g, H

    def nll(self, beta) -> float:
        return float(self.terms(beta, 0)[0])


def concordance_index(time: np.ndarray, event: np.ndarray,
                      lp: np.ndarray, max_pairs: int = 4_000_000) -> float:
    """Harrell's C over comparable pairs (i an event, t_i < t_j); ties in
    lp count 1/2. Above ``max_pairs`` pairs a seeded subsample of the
    events, as in the reference."""
    ok = np.isfinite(time) & np.isfinite(lp) & np.isfinite(event)
    time, event, lp = time[ok], event[ok], lp[ok]
    n = len(time)
    ev_idx = np.flatnonzero(event > 0)
    if len(ev_idx) == 0 or n < 2:
        return 0.5
    if len(ev_idx) * n > max_pairs:
        rng = np.random.RandomState(0)
        ev_idx = rng.choice(ev_idx, size=max(1, max_pairs // n),
                            replace=False)
    conc = ties = tot = 0.0
    for i in ev_idx:
        cmp_mask = time > time[i]
        m = cmp_mask.sum()
        if m == 0:
            continue
        conc += float((lp[i] > lp[cmp_mask]).sum())
        ties += float((lp[i] == lp[cmp_mask]).sum())
        tot += float(m)
    return float((conc + 0.5 * ties) / tot) if tot > 0 else 0.5


class CoxPHModel(Model):
    algo = "coxph"

    def __init__(self, params, output, coef: np.ndarray, di_stats: dict,
                 features: List[str]):
        super().__init__(params, output)
        self.coef = coef
        self.di_stats = di_stats
        self.features = features

    def _lp(self, frame: Frame) -> np.ndarray:
        """The centred linear predictor of the frame's logical rows."""
        require_local(frame, self.algo)
        di = build_datainfo(frame, self.features, standardize=False,
                            use_all_factor_levels=False,
                            stats_override=self.di_stats)
        coef = torch.from_numpy(self.coef.astype(np.float32)).to(frame.device)
        with exact_f32():
            eta = di.X @ coef
        return (eta - self.output["eta_mean"]).cpu().numpy()[:frame.nrows]

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return {"lp": self._lp(frame)}

    def model_performance(self, frame: Frame, mask_weights=None):
        lp = self._lp(frame)
        times = frame.col(self.params["stop_column"]).to_numpy()
        ev = frame.col(self.output["response"]).to_numpy().astype(float)
        c = concordance_index(times, ev, lp)
        return mm.ModelMetrics("CoxPH", int(np.isfinite(times).sum()),
                               float(np.mean(lp ** 2)), concordance=c,
                               loglik=self.output.get("loglik"))


class CoxPHEstimator(ModelBuilder):
    """h2o-py H2OCoxProportionalHazardsEstimator surface: y is the event
    indicator (0/1 or a two-level categorical), ``stop_column`` the
    event or censoring time, ``start_column`` the entry time and
    ``stratify_by`` the strata columns."""

    algo = "coxph"
    label = "CoxPH"

    DEFAULTS = dict(
        start_column=None, stop_column=None, stratify_by=None,
        ties="efron", max_iterations=20, lre_min=9.0,
        weights_column=None, ignored_columns=None, nfolds=0,
        fold_column=None, seed=-1,
    )
    PORTED = frozenset(DEFAULTS) - {"nfolds", "fold_column"}
    UNPORTED_WHY = dict(
        ModelBuilder.UNPORTED_WHY,
        nfolds="the reference's cross-validation of CoxPH fails (its "
               "model scores no predict column)",
        fold_column="the reference's cross-validation of CoxPH fails (its "
                    "model scores no predict column)")

    def resolve_x(self, frame, x, y):
        x = super().resolve_x(frame, x, y)
        drop = {self.params.get("start_column"),
                self.params.get("stop_column")}
        drop |= set(self.params.get("stratify_by") or [])
        return [n for n in x if n not in drop]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        require_local(frame, self.label)
        p = self.params
        stop_c = p["stop_column"]
        if stop_c is None:
            raise ValueError("CoxPH requires stop_column")
        n = frame.nrows
        stop = frame.col(stop_c).to_numpy().astype(np.float64)
        start = (frame.col(p["start_column"]).to_numpy().astype(np.float64)
                 if p["start_column"] else np.full(n, -np.inf))
        ev = np.nan_to_num(frame.col(y).to_numpy().astype(np.float64))
        strata = np.zeros(n, np.int64)
        for sc in (p["stratify_by"] or []):
            c = frame.col(sc)
            codes = np.nan_to_num(c.host_view(), nan=0.0).astype(np.int64)
            strata = strata * max(c.cardinality, 1) + np.maximum(codes, 0)
        rs = _risk_structure(start, stop, ev, strata)

        di = build_datainfo(frame, x, standardize=False,
                            use_all_factor_levels=False)
        w = np.ones(n, np.float32)
        if p.get("weights_column"):
            w *= np.nan_to_num(frame.col(p["weights_column"]).to_numpy(),
                               nan=0.0)
        ok = np.isfinite(stop) & np.isfinite(ev)
        w *= ok.astype(np.float32)
        dev = frame.device
        w_d = torch.from_numpy(w).to(dev)
        X = di.X[:n]
        with exact_f32():
            xmean = (w_d @ X).double() / max(float(w.sum()), 1e-12)
        data = _CoxData((X - xmean.float()).contiguous(), w_d, ev, rs,
                        efron=str(p["ties"]).lower() != "breslow")
        P = di.P

        beta = torch.zeros(P, dtype=torch.float32, device=dev)
        loglik0 = -data.nll(beta)
        loglik = loglik0
        eye = torch.eye(P, dtype=torch.float64, device=dev)
        iters = 0
        for _ in range(int(p["max_iterations"])):
            iters += 1
            _, g, H = data.terms(beta, 2)
            step = torch.linalg.solve(H + 1e-6 * eye, g).to(torch.float32)
            lam, f_old, f_new = 1.0, -loglik, None
            for _ in range(10):
                f_new = data.nll(beta - lam * step)
                if np.isfinite(f_new) and f_new <= f_old:
                    break
                lam *= 0.5
                f_new = None
            beta = beta - lam * step
            new_ll = -(f_new if f_new is not None else data.nll(beta))
            if abs(new_ll - loglik) < 10.0 ** (-float(p["lre_min"])) * \
                    max(abs(loglik), 1.0):
                loglik = new_ll
                break
            loglik = new_ll

        H = data.terms(beta, 2)[2].cpu().numpy()
        try:
            cov = np.linalg.inv(H + 1e-8 * np.eye(P))
            se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        except np.linalg.LinAlgError:
            se = np.full(P, np.nan)
        beta_np = beta.cpu().numpy().astype(np.float64)
        with exact_f32():
            eta = (X @ beta).cpu().numpy()
        eta_mean = float((eta * w).sum() / max(w.sum(), 1e-12))
        coef_table = [
            {"name": nm, "coef": float(b), "exp_coef": float(np.exp(b)),
             "se_coef": float(s),
             "z_coef": float(b / s) if s > 0 else float("nan")}
            for nm, b, s in zip(di.coef_names, beta_np, se)]
        output = {"category": "CoxPH", "response": y, "names": list(x),
                  "x_mean_design": [float(v) for v in xmean.cpu().numpy()],
                  "coef_names": di.coef_names, "domain": None,
                  "loglik": loglik, "null_loglik": loglik0,
                  "lre": float(abs(loglik - loglik0)),
                  "coefficients_table": coef_table,
                  "n_events": int(ev[ok].sum()), "n": int(ok.sum()),
                  "eta_mean": eta_mean, "ties": p["ties"],
                  "iterations": iters, "n_groups": rs["n_groups"]}
        model = CoxPHModel(p, output, beta_np, stats_of(di), list(x))
        model.training_metrics = model.model_performance(frame)
        return model

    @property
    def coefficients(self):
        return None
