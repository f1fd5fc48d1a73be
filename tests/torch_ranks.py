"""Multi-rank runs of the PyTorch port for the tests: W processes, one
rank each, joined over gloo, their tensors on the CPU (or all on one
card, for the ``gpu`` tests).

    python tests/torch_ranks.py <scenario> <rank> <world> <run_dir> [device]

Each rank forms the mesh with ``core.cloud.init("gloo", ...)`` (a
``file://`` rendezvous in ``run_dir``), runs one scenario on its own
rows and pickles what it computed to ``run_dir/<scenario>-<rank>.pkl``.
The test modules start the ranks once per module with ``run_ranks`` and
hold the results against the JAX reference, which they compute in their
own process. This module's top-level imports are numpy, torch and the
port only, so a rank never loads JAX or the reference package.

Scenarios: ``mesh`` (collectives, partitioned ingest and binning),
``fixed`` (fixed-point exponents and sums over the ranks),
``level`` (the sharded tree level, levels 0..2), ``fit`` (W-rank GBM
fits — binomial, gaussian, multinomial, and binomial with an offset
column and a monotone constraint — scoring and metrics), ``trees``
(W-rank DRF, the XGBoost facade, Uplift DRF and the isolation forests,
``TREE_CASES``; the isolation trees also grown from the reference's
draws) and ``glm_dl`` (W-rank GLM and DeepLearning fits,
``GLM_CASES`` and ``DL_CASES``; DL's first steps one at a time).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120.0


def run_ranks(scenario: str, run_dir: Path, world: int = 2,
              timeout: float = JOIN_TIMEOUT_S, device: str = "cpu") -> list:
    """Start ``world`` ranks of ``scenario`` with their tensors on
    ``device`` (every rank on the same one), wait at most ``timeout``
    seconds for all of them (then kill every rank and fail), and return
    each rank's results in rank order. ``run_dir`` may hold
    ``input.pkl`` for the ranks to read."""
    return start_ranks(scenario, run_dir, world, timeout, device)()


def start_ranks(scenario: str, run_dir: Path, world: int = 2,
                timeout: float = JOIN_TIMEOUT_S, device: str = "cpu"):
    """``run_ranks`` started: returns the function that waits for the
    ranks and returns their results, so the caller can work meanwhile."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world),
         str(run_dir), device], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    return lambda: _join(procs, deadline, timeout, scenario, run_dir, world)


def _join(procs, deadline, timeout, scenario, run_dir, world) -> list:
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = (p.communicate()[0] or "") + f"\n[killed after {timeout} s]"
        logs.append(out)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("\n".join(
            f"--- rank {r} rc={p.returncode} ---\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    results = []
    for r in range(world):
        with open(run_dir / f"{scenario}-{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ------------------------------------------------------------ shared data


def mesh_cols(n=517, seed=3):
    """Mixed columns with NAs: numeric, string categorical, numeric
    forced categorical, integer codes with a domain, a response."""
    r = np.random.RandomState(seed)
    a = r.randn(n)
    a[::37] = np.nan
    s = r.choice(["red", "green", "blue", "zz"], n).astype(object)
    s[4] = None
    s[300] = None
    k = r.choice([3.0, 1.5, 10.0, -2.0], n)
    k[::53] = np.nan
    c = r.randint(0, 3, n)
    c[::41] = -1
    y = (np.nan_to_num(a) + (s == "red") > 0.3).astype(np.int32)
    cols = {"a": a, "s": s, "k": k, "c": c, "y": y}
    return cols, ["k"], {"c": ["p", "q", "r"], "y": ["N", "Y"]}


def dyadic_inputs(n=400, F=4, B=17, seed=0, na_frac=0.1):
    """tests/test_torch_treekernel.py's dyadic level inputs: small-integer
    stats, so every float32 sum is exact in any order."""
    r = np.random.RandomState(seed)
    bins = r.randint(0, B - 1, (n, F))
    bins[r.rand(n, F) < na_frac] = B - 1
    w = (r.rand(n) > 0.05).astype(np.float32)
    g = r.randint(-4, 5, n).astype(np.float32)
    h = r.randint(1, 5, n).astype(np.float32)
    stats = np.stack([w, w * g, w * h], axis=1).astype(np.float32)
    return bins.astype(np.int8), stats, r


_INF = np.array([np.inf], np.float32)
LEVEL_CASES = ("numeric", "categorical", "constraints_depth_limit",
               "per_node_col_mask", "uneven_rows")
LEVEL_DEPTH = 2


def level_case(case):
    """(bins, stats, B, is_cat, cons, lo, hi, col mask per level,
    (min_rows, reg_lambda, msi, depth limit)) — the cases of
    test_level_parity_with_pallas_kernel, plus uneven rows: 397 rows
    padded to 400 with NA-bin rows of zero weight."""
    F, B, seed, n = 4, 17, 0, 400
    is_cat = cons = None
    lo, hi = -_INF, _INF
    scal = (3.0, 1.0, 1e-5, 30)
    masks = {d: np.ones(F, bool) for d in range(LEVEL_DEPTH + 1)}
    if case == "categorical":
        B, seed = 9, 3
        is_cat = np.array([True, False, True, False])
    elif case == "constraints_depth_limit":
        seed = 5
        cons = np.array([1, -1, 0, 0], np.int8)
        lo = np.array([-0.5], np.float32)
        hi = np.array([0.5], np.float32)
        scal = (3.0, 1.0, 1e-5, 2)     # d=2 splits masked by the limit
    elif case == "per_node_col_mask":
        seed = 7
        rm = np.random.RandomState(17)
        masks = {d: (rm.rand(2 ** d, F) > 0.4) | (np.arange(F) == 0)
                 for d in range(LEVEL_DEPTH + 1)}
    elif case == "uneven_rows":
        seed, n = 9, 397
    bins, stats, _ = dyadic_inputs(n=n, F=F, B=B, seed=seed)
    pad = 400 - n
    bins = np.concatenate([bins, np.full((pad, F), B - 1, np.int8)])
    stats = np.concatenate([stats, np.zeros((pad, 3), np.float32)])
    return bins, stats, B, is_cat, cons, lo, hi, masks, scal


def mixed_cols(n=700, seed=0):
    """Binomial columns after tests/test_tree_kernels.py's _mixed_frame:
    NAs and a categorical."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    X[r.rand(n) < 0.05, 0] = np.nan
    cat = r.choice(["a", "b", "c", "d"], n)
    y = (X[:, 1] + (cat == "a") * 1.5 + 0.3 * r.randn(n) > 0).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["c"] = cat
    cols["y"] = np.array(["N", "Y"], object)[y]
    return cols, ["c", "y"]


def regression_cols(n=600, seed=1):
    """Regression columns with NAs and a categorical."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    X[r.rand(n) < 0.05, 2] = np.nan
    k = r.choice(["p", "q", "r"], n)
    y = 2.0 * X[:, 0] + np.sin(2 * X[:, 1]) + (k == "q") * 1.5 \
        + 0.1 * r.randn(n)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["k"] = k
    cols["y"] = y
    return cols, ["k"]


def multi_cols(n=600, K=3, seed=2):
    """Multinomial columns: three integer-valued features of six levels
    (so few bins lie empty inside a node: no plateau of equal-gain
    thresholds), NAs in x0, a categorical, and a K-level response from a
    per-class signal."""
    r = np.random.RandomState(seed)
    X = r.randint(0, 6, (n, 3)).astype(float)
    X[r.rand(n) < 0.05, 0] = np.nan
    cat = r.choice(["a", "b", "c", "d"], n)
    z = np.stack([X[:, 1] * (k - 1) + (cat == "abcd"[k % 4]) * 1.2
                  + 0.5 * np.nan_to_num(X[:, 0]) * (k % 2)
                  for k in range(K)], 1) + 0.4 * r.randn(n, K)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["c"] = cat
    cols["y"] = np.array([f"k{k}" for k in range(K)], object)[z.argmax(1)]
    return cols, ["c", "y"]


def offset_cols(n=700, seed=6):
    """``mixed_cols`` with an offset column ``off``."""
    cols, cats = mixed_cols(n=n, seed=seed)
    cols["off"] = 0.3 * np.random.RandomState(seed + 1).randn(n)
    return cols, cats


FIT_PARAMS = dict(ntrees=4, max_depth=4, seed=11, sample_rate=1.0,
                  col_sample_rate_per_tree=1.0)
# seed 6: binomial data without near-tie splits (test_torch_gbm.py)
FIT_CASES = {
    "binomial": (lambda: mixed_cols(seed=6), {}),
    "gaussian": (regression_cols, dict(distribution="gaussian",
                                       min_rows=5.0)),
    # seed 3: tie-free against the reference's data = 2 fit too
    "multinomial": (lambda: multi_cols(seed=3), {}),
    # each rank's own offset rows; the monotone bounds replicated
    "binomial_offset_monotone": (offset_cols, dict(
        offset_column="off", monotone_constraints={"x1": 1})),
}


def uplift_cols(n=2000, seed=21):
    """tests/test_torch_uplift.py's uplift data: x0 > 0 defines the
    responders to treatment; x1 is a prognostic factor."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    treat = r.randint(0, 2, n)
    base = 0.2 + 0.2 * (X[:, 1] > 0)
    lift = 0.35 * ((X[:, 0] > 0) & (treat == 1))
    y = (r.rand(n) < base + lift).astype(int)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "treatment": np.where(treat == 1, "treatment",
                                  "control").astype(object),
            "conversion": np.where(y == 1, "yes", "no").astype(object)}
    return cols, ["treatment", "conversion"]


def anomaly_cols(n=3001, frac=0.01, seed=3):
    """tests/test_torch_isofor.py's anomaly data: four numerics (NAs in
    x3), a categorical, ``frac`` of the rows planted far out in x0..x2."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    bad = np.zeros(n, bool)
    bad[r.choice(n, int(frac * n), replace=False)] = True
    X[bad, :3] = r.uniform(4.0, 7.0, (bad.sum(), 3)) \
        * r.choice([-1.0, 1.0], (bad.sum(), 3))
    X[r.rand(n) < 0.03, 3] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["c"] = r.choice(["a", "b", "c"], n)
    return cols, ["c"]


ISO_NUM = ["x0", "x1", "x2", "x3"]
ISO_DEPTH = 7
ISO_BAG = 400
XGB = dict(nrounds=4, max_depth=4, seed=11, subsample=1.0,
           colsample_bytree=1.0, eta=0.3, reg_lambda=0.5, gamma=1e-3,
           max_bins=40)
# (estimator, columns, response, params); sampling on where only the
# port's world-1 fit is the comparison (the packages' draws differ)
TREE_CASES = {
    "drf_binomial": ("drf", lambda: mixed_cols(seed=6), "y", dict(
        ntrees=4, max_depth=6, seed=11, sample_rate=1.0, mtries=5)),
    "drf_regression": ("drf", lambda: regression_cols(seed=2), "y", dict(
        ntrees=4, max_depth=6, seed=11, sample_rate=1.0, mtries=4,
        min_rows=5.0)),
    "drf_multinomial": ("drf", lambda: multi_cols(seed=3), "y", dict(
        ntrees=3, max_depth=5, seed=11)),
    "drf_sampled": ("drf", lambda: mixed_cols(seed=6), "y", dict(
        ntrees=4, max_depth=6, seed=11, col_sample_rate_per_tree=0.7)),
    "xgboost": ("xgboost", lambda: mixed_cols(seed=6), "y", XGB),
    "uplift": ("uplift", uplift_cols, "conversion", dict(
        treatment_column="treatment", ntrees=3, max_depth=5,
        sample_rate=1.0, mtries=-2, seed=7)),
    "uplift_sampled": ("uplift", uplift_cols, "conversion", dict(
        treatment_column="treatment", ntrees=3, max_depth=5, mtries=2,
        seed=7)),
    "isofor": ("isofor", anomaly_cols, None, dict(ntrees=6, seed=4)),
    "extisofor": ("extisofor", anomaly_cols, None, dict(
        ntrees=6, seed=4, extension_level=2)),
}
TREE_REF_CASES = ("drf_binomial", "drf_regression", "xgboost", "uplift")


def glm_cols(n=3000, seed=0, response="binomial", bias=0.0):
    """tests/test_torch_glm.py's mixed columns: three numerics (NAs in
    x2, x1 on a wide scale), two categoricals (NAs in c1)."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    X[:, 1] = 40.0 + 15.0 * X[:, 1]
    c0 = r.choice(["red", "green", "blue", "grey"], n)
    c1 = r.choice(["a", "b", "c"], n).astype(object)
    eta = (0.8 * X[:, 0] - 0.02 * (X[:, 1] - 40) + 0.3 * X[:, 2]
           + 0.6 * (c0 == "green") - 0.4 * (c1 == "c") + bias)
    X[r.rand(n) < 0.05, 2] = np.nan
    c1[r.rand(n) < 0.04] = None
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "c0": c0, "c1": c1}
    if response == "binomial":
        cols["y"] = np.array(["no", "yes"], object)[
            (r.rand(n) < 1 / (1 + np.exp(-eta))).astype(int)]
        return cols, ["c0", "c1", "y"]
    cols["y"] = 2.0 + eta + 0.3 * r.randn(n)
    return cols, ["c0", "c1"]


def family_cols(family: str, n=2501, seed=7):
    """tests/test_torch_glm.py's family columns (default links): positive
    predictors and a response in ``family``'s domain."""
    r = np.random.RandomState(seed)
    x0 = r.rand(n) + 0.5
    x1 = r.rand(n)
    c = r.choice(["p", "q", "s"], n)
    eta_lin = 0.4 + 0.5 * x0 + 0.3 * x1 + 0.2 * (c == "q")
    mu = np.exp(eta_lin - 0.5) if family in ("poisson", "gamma") \
        else eta_lin
    if family == "poisson":
        y = r.poisson(mu).astype(float)
    elif family == "gamma":
        y = r.gamma(4.0, mu / 4.0)
    else:
        y = mu + 0.1 * r.randn(n)
    return {"x0": x0, "x1": x1, "c": c, "y": y}, ["c"]


GLM_CASES = {
    "binomial_irlsm": (lambda: glm_cols(), dict(
        family="binomial", lambda_=0.0, solver="irlsm", beta_epsilon=1e-6)),
    "gamma_irlsm": (lambda: family_cols("gamma"), dict(
        family="gamma", lambda_=0.0, solver="irlsm", beta_epsilon=1e-6)),
    "gaussian_lbfgs": (lambda: family_cols("gaussian", seed=8), dict(
        family="gaussian", lambda_=0.0, solver="l_bfgs",
        max_iterations=60)),
    "poisson_cod": (lambda: family_cols("poisson", seed=8), dict(
        family="poisson", lambda_=0.0, solver="coordinate_descent",
        max_iterations=10)),
    "binomial_admm": (lambda: glm_cols(seed=1), dict(
        family="binomial", alpha=1.0, lambda_=1e-3, solver="irlsm")),
    "gaussian_lambda_search": (
        lambda: glm_cols(seed=2, response="gaussian", bias=1.5), dict(
            family="gaussian", alpha=0.5, lambda_search=True, nlambdas=8,
            lambda_min_ratio=1e-3)),
}


def dl_cols(n=4096, seed=0):
    """tests/test_torch_deeplearning.py's columns: five numerics (NAs in
    x2, x3 on a wide scale), a categorical with NAs, binomial, 4-class
    and real responses."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 5)
    X[:, 3] = 50.0 + 20.0 * X[:, 3]
    c0 = r.choice(["red", "green", "blue"], n).astype(object)
    eta = (X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 4]
           + 0.02 * (X[:, 3] - 50) + 0.7 * (c0 == "green"))
    X[r.rand(n) < 0.05, 2] = np.nan
    c0[r.rand(n) < 0.03] = None
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["c0"] = c0
    cols["yb"] = np.array(["no", "yes"], object)[
        (r.rand(n) < 1 / (1 + np.exp(-eta))).astype(int)]
    cols["ym"] = np.array(["a", "b", "c", "d"], object)[
        np.clip(np.floor(eta + 2 + 0.5 * r.randn(n)), 0, 3).astype(int)]
    cols["yr"] = 3.0 + 2.0 * np.tanh(eta) + 0.2 * r.randn(n)
    return cols


DL_X = ["x0", "x1", "x2", "x3", "x4", "c0"]
# (response, params, from the reference's initial weights, rows). The
# reference pads 4,096 rows as the port does (its batch starts agree);
# dropout fits draw the port's masks, so only the world-1 fit compares,
# on 4,000 rows: the ranks' halves are not a whole number of 128-row
# batches, so one batch straddles them
DL_CASES = {
    "rectifier": ("yb", dict(hidden=[16, 8], epochs=6, seed=1), True, 4096),
    "tanh": ("yr", dict(hidden=[16, 8], epochs=6, seed=1,
                        activation="Tanh"), True, 4096),
    "rectifier_dropout": ("yb", dict(hidden=[16, 8], epochs=4, seed=1,
                                     activation="RectifierWithDropout",
                                     input_dropout_ratio=0.1), False, 4000),
    "tanh_dropout": ("ym", dict(hidden=[16, 8], epochs=4, seed=1,
                                activation="TanhWithDropout"), False, 4000),
}
DL_REPLAY_CASE = "rectifier_dropout"
DL_REPLAY = 17          # steps replayed one at a time (15 on rank 0)


def dl_from_weights(init):
    """An ``init_params`` that returns ``init`` (a net's numpy arrays)."""
    def draw(gen, sizes, maxout, device):
        return [{k: torch.from_numpy(np.array(l[k], np.float32)).to(device)
                 for k in ("W", "b")} for l in init]
    return draw


def dl_replay(est, fr, y, steps: int):
    """The nets after each of a fit's first ``steps`` steps, one step at
    a time (``DeepLearningEstimator.prepare`` + ``train_steps``)."""
    from h2o3_tpu_torch.models import deeplearning as dl
    from h2o3_tpu_torch.ops.gram import exact_f32
    out = []
    with exact_f32():
        t = est.prepare(fr, DL_X, y)
        for k in range(steps):
            dl.train_steps(t.net, t.opt, t.X, t.y, t.w, t.gen, t.cfg,
                           t.sched, k, 1, t.n, t.shard)
            out.append([{key: l[key].detach().numpy().copy()
                         for key in ("W", "b")} for l in t.net])
    return out


# ---------------------------------------------------------------- ranks


def _owned(cols, mesh, block=8):
    from h2o3_tpu_torch.parallel.mesh import owned_rows
    n = len(next(iter(cols.values())))
    lo, hi = owned_rows(n, mesh, block)
    return {k: v[lo:hi] for k, v in cols.items()}, n


def _columns(fr):
    return {name: dict(type=fr.col(name).type,
                       data=fr.col(name).data.numpy(),
                       na=fr.col(name).na_mask.numpy(),
                       domain=fr.col(name).domain,
                       host=fr.col(name).host_view(),
                       nrows=fr.col(name).nrows)
            for name in fr.names}


def scenario_mesh(mesh):
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.parallel import map_reduce, mesh as mesh_mod
    out = {}
    npad = mesh_mod.padded_rows(101, mesh, 4)
    lo, hi = mesh_mod.partition_bounds(npad, mesh)
    x = torch.arange(lo, hi, dtype=torch.float64)
    out["fetch"] = mesh_mod.fetch_replicated(x, mesh)
    out["reduce"] = map_reduce.frame_reduce(
        lambda v: {"sum": v.sum().reshape(1), "sq": (v * v).sum().reshape(1),
                   "n": torch.tensor([v.numel()])}, x, mesh=mesh)
    out["map"] = map_reduce.frame_map(lambda v: v * 2, x, mesh=mesh).numpy()
    cols, cats, domains = mesh_cols()
    local, n = _owned(cols, mesh)
    fr = Frame.from_numpy_partitioned(local, n, categorical=cats,
                                      domains=domains, mesh=mesh)
    out["span"], out["npad"] = fr.span, fr.nrows_padded
    out["valid"] = fr.valid_weights().numpy()
    out["cols"] = _columns(fr)
    bm = bin_frame(fr, ["a", "s", "k", "c"], nbins=8, nbins_cats=2)
    out["bins"], out["edges"] = bm.bins.numpy(), bm.edges.numpy()
    out["nbins"], out["B"] = bm.nbins.numpy(), bm.nbins_total
    return out


def fixed_cols(n=517, seed=12):
    """[n, 3] float32 values whose magnitudes grow along the rows (the
    ranks' maxima differ), an infinity and a NaN, and segment ids."""
    r = np.random.RandomState(seed)
    v = (r.randn(n, 3) * np.linspace(0.5, 300.0, n)[:, None]).astype(
        np.float32)
    v[3, 1], v[n - 5, 2] = np.inf, np.nan
    return v, r.randint(0, 6, n).astype(np.int32)


def scenario_fixed(mesh):
    from h2o3_tpu_torch.ops import fixed_point as fp
    v, ids = fixed_cols()
    local, _ = _owned({"v": v, "ids": ids}, mesh)
    vals = torch.from_numpy(local["v"])
    return {"exps": fp.exponents(vals, mesh=mesh).numpy(),
            "sums": fp.index_sum(torch.from_numpy(local["ids"]), vals, 6,
                                 mesh=mesh).numpy(),
            "rows": vals.shape[0]}


def scenario_level(mesh):
    from h2o3_tpu_torch.models.tree import TreeScalars
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    from h2o3_tpu_torch.parallel.mesh import partition_bounds
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(mesh.device)
    out = {}
    for case in LEVEL_CASES:
        bins, stats, B, is_cat, cons, lo_b, hi_b, masks, scal = \
            level_case(case)
        lo, hi = partition_bounds(bins.shape[0], mesh)
        min_rows, lam, msi, dl = scal
        sc = TreeScalars(torch.tensor(min_rows), torch.tensor(lam),
                         torch.tensor(msi), torch.tensor(dl,
                                                         dtype=torch.int32))
        nb = np.full(bins.shape[1], B - 1, np.int32)
        levels, prev = [], None
        nid = torch.zeros(hi - lo, dtype=torch.int32, device=mesh.device)
        for d in range(LEVEL_DEPTH + 1):
            o = tk.fused_level(
                t(bins[lo:hi]), nid, t(stats[lo:hi]), prev, t(masks[d]),
                t(nb), t(is_cat), t(cons), t(lo_b), t(hi_b), sc, d=d,
                n_nodes=2 ** d, n_bins=B, mesh=mesh)
            levels.append([x.cpu().numpy() for x in o])
            prev, nid = o[0], o[-1]
        out[case] = levels
    return out


def scenario_fit(mesh, run_dir):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.convert import gbm_model_from_arrays
    from h2o3_tpu_torch.models.tree import Tree
    with open(run_dir / "input.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for case, (make, extra) in FIT_CASES.items():
        cols, cats = make()
        local, n = _owned(cols, mesh)
        fr = h2o.Frame.from_numpy_partitioned(local, n, categorical=cats,
                                              mesh=mesh)
        m = h2o.GBMEstimator(**FIT_PARAMS, **extra).train(fr, y="y")
        pred = m.predict(fr)
        out[case] = dict(
            forest={f: getattr(m.forest, f).numpy() for f in Tree._fields},
            metrics=m.training_metrics.to_dict(),
            perf=m.model_performance(fr).to_dict(),
            output={k: m.output[k] for k in ("init_f", "varimp",
                                             "default_threshold")
                    if k in m.output},
            f0=np.asarray(m.f0),
            raw=m._score_raw(fr), span=fr.span,
            pred={c: pred.col(c).host_view() for c in pred.names},
            pred_local={c: pred.col(c).data.numpy() for c in pred.names})
        conv = gbm_model_from_arrays(inputs[case], device="cpu")
        out[case]["converted"] = dict(
            raw=conv._score_raw(fr), perf=conv.model_performance(fr).to_dict())
        if case == "binomial":
            # sampled: the ranks' row draws differ, their column masks not
            m = h2o.GBMEstimator(**dict(FIT_PARAMS, sample_rate=0.7,
                                        col_sample_rate_per_tree=0.5)).train(
                fr, y="y")
            out["sampled"] = {f: getattr(m.forest, f).numpy()
                              for f in Tree._fields}
    return out


def _metrics(m) -> dict:
    tm = m.training_metrics
    return tm.to_dict() if hasattr(tm, "to_dict") else dict(tm)


def _scored(m, fr) -> dict:
    """A model's fit and its scores on the partitioned frame it trained
    on."""
    pred = m.predict(fr)
    perf = m.model_performance(fr)
    return dict(metrics=_metrics(m), raw=m._score_raw(fr), span=fr.span,
                perf=perf.to_dict() if hasattr(perf, "to_dict") else perf,
                pred={c: pred.col(c).host_view() for c in pred.names},
                pred_local={c: pred.col(c).data.numpy()
                            for c in pred.names})


def tree_estimator(kind: str, params: dict):
    import h2o3_tpu_torch as h2o
    return {"drf": h2o.DRFEstimator, "xgboost": h2o.XGBoostEstimator,
            "uplift": h2o.UpliftDRFEstimator,
            "isofor": h2o.IsolationForestEstimator,
            "extisofor": h2o.ExtendedIsolationForestEstimator}[kind](**params)


def forest_arrays(m) -> dict:
    """A tree model's forest (and an uplift model's leaf rates) as numpy
    arrays."""
    f = m.forest
    out = {k: getattr(f, k).numpy() for k in f._fields}
    for k in ("leaf_pt", "leaf_pc"):
        if hasattr(m, k):
            out[k] = getattr(m, k).numpy()
    return out


def scenario_trees(mesh, run_dir):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.models import extisofor, isofor
    from h2o3_tpu_torch.parallel import map_reduce
    with open(run_dir / "input.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for case, (kind, make, y, params) in TREE_CASES.items():
        cols, cats = make()
        local, n = _owned(cols, mesh)
        fr = h2o.Frame.from_numpy_partitioned(local, n, categorical=cats,
                                              mesh=mesh)
        map_reduce.reset_collectives()
        m = tree_estimator(kind, params).train(fr, y=y)
        out[case] = dict(_scored(m, fr), forest=forest_arrays(m),
                         collectives=dict(map_reduce.COLLECTIVES))
    # isolation trees grown from the reference's draws and bags
    cols, cats = anomaly_cols()
    local, n = _owned(cols, mesh)
    fr = h2o.Frame.from_numpy_partitioned(local, n, categorical=cats,
                                          mesh=mesh)
    bm = bin_frame(fr, list(cols), nbins=64, nbins_cats=64,
                   histogram_type="uniform")
    X, _ = extisofor.feature_matrix(fr, ISO_NUM)
    grown = {"isofor": [], "extisofor": []}
    for d in inputs["iso_draws"]:
        w = torch.from_numpy(fr.local_rows(d["keep"]))
        t = isofor.grow_isolation_tree(
            bm.bins, w, *(torch.from_numpy(d[k]) for k in
                          ("feat", "thresh", "na_left")),
            B=bm.nbins_total, mesh=mesh)
        grown["isofor"].append(dict(
            {k: getattr(t, k).numpy() for k in ("is_split", "thresh",
                                                 "leaf_w", "leaf")},
            plen=isofor.tree_path_length(t, bm.bins,
                                         bm.nbins_total).numpy()))
    for d in inputs["ext_draws"]:
        w = torch.from_numpy(fr.local_rows(d["keep"]))
        t = extisofor.grow_ext_tree(X, w, torch.from_numpy(d["normals"]),
                                    torch.from_numpy(d["offsets"]), mesh)
        grown["extisofor"].append({k: getattr(t, k).numpy()
                                   for k in ("is_split", "leaf")})
    out["grown"] = grown
    return out


def scenario_glm_dl(mesh, run_dir):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models import deeplearning as dl
    from h2o3_tpu_torch.parallel import map_reduce
    with open(run_dir / "input.pkl", "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for case, (make, params) in GLM_CASES.items():
        cols, cats = make()
        local, n = _owned(cols, mesh)
        fr = h2o.Frame.from_numpy_partitioned(local, n, categorical=cats,
                                              mesh=mesh)
        map_reduce.reset_collectives()
        m = h2o.GLMEstimator(**params).train(fr, y="y")
        out["glm_" + case] = dict(
            _scored(m, fr), coefs=m.coefficients, coef=np.asarray(m.coef),
            path=getattr(m, "_coef_path", None),
            lambdas=getattr(m, "_lambda_path_vals", None),
            collectives=dict(map_reduce.COLLECTIVES))
    draw = dl.init_params
    try:
        for case, (y, params, ref_init, rows) in DL_CASES.items():
            local, n = _owned(dl_cols(rows), mesh)
            fr = h2o.Frame.from_numpy_partitioned(local, n, mesh=mesh)
            dl.init_params = (dl_from_weights(inputs["dl_init"][case])
                              if ref_init else draw)
            map_reduce.reset_collectives()
            est = h2o.DeepLearningEstimator(**params)
            m = est.train(fr, y=y, x=DL_X)
            res = dict(_scored(m, fr), steps=m._steps_trained,
                       history=m.output["scoring_history"],
                       net=[{k: l[k].numpy() for k in ("W", "b")}
                            for l in m.net],
                       collectives=dict(map_reduce.COLLECTIVES))
            if case == DL_REPLAY_CASE:
                res["replay"] = dl_replay(est, fr, y, DL_REPLAY)
            out["dl_" + case] = res
    finally:
        dl.init_params = draw
    return out


def main(argv) -> int:
    from h2o3_tpu_torch.core import cloud
    scenario, rank, world, run_dir = argv[1], int(argv[2]), int(argv[3]), \
        Path(argv[4])
    torch.set_num_threads(1)
    mesh = cloud.init("gloo", rank, world,
                      f"file://{run_dir / 'rendezvous'}", device=argv[5])
    try:
        if scenario == "mesh":
            out = scenario_mesh(mesh)
        elif scenario == "fixed":
            out = scenario_fixed(mesh)
        elif scenario == "level":
            out = scenario_level(mesh)
        elif scenario == "fit":
            out = scenario_fit(mesh, run_dir)
        elif scenario == "trees":
            out = scenario_trees(mesh, run_dir)
        elif scenario == "glm_dl":
            out = scenario_glm_dl(mesh, run_dir)
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
        with open(run_dir / f"{scenario}-{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        cloud.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
