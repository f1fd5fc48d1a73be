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
``level`` (the sharded tree level, levels 0..2) and ``fit`` (W-rank GBM
fits — binomial, gaussian, multinomial, and binomial with an offset
column and a monotone constraint — scoring and metrics).
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
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world),
         str(run_dir), device], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
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
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
        with open(run_dir / f"{scenario}-{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        cloud.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
