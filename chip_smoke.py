#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits non-zero and no phase carries on:

1. Toolchain: torch / CUDA / nvcc versions and the card's name and power
   limit; build the kernels (one nvcc per source, in parallel).
2. Each level kernel against its plain version on the card, at the
   flagship width (F=10, B=126, int8 bins, 1M rows, levels d=0..5), one
   level at Lh=256 (depth bucket 10) and one int32-bin level at B=200.
   Small-integer ("dyadic") stats must match EXACTLY; real-valued stats
   within the stated tolerance, split flips only at near-ties.
3. One ``grow_tree`` on the airlines bins with dyadic g/h, through the
   kernels and through the plain versions: the Trees must be equal.
4. The main path: a 5M-row airlines-schema frame, ``GBMEstimator(
   ntrees=10, max_depth=6, seed=1).train`` and ``predict``, with every
   launch count = 10 trees x 6 levels; training metrics, throughput and
   peak memory; the output checked against the CPU plain path on a small
   sample; then the binning pass alone and one more fit under
   torch.profiler (where the time goes).
5. Kernel timings at the main path's shapes (5M rows, d=0..5) with CUDA
   events, beside their plain versions, a library yardstick and the
   bound from bytes and operations.

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 rate outside tensor cores
FLAGSHIP = dict(ntrees=10, max_depth=6, seed=1)
N_MAIN = 5_000_000
N_KERNEL = 1_000_000
TREEKERNEL_SRC = "h2o3_tpu_torch/ops/kernels/csrc/treekernel.cu"
REPLACES = "h2o3_tpu/ops/pallas/treekernel.py:250"
CARD = ""


def say(*parts) -> None:
    print(*parts, f"[{CARD}]", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ------------------------------------------------------------------ data


def airlines_arrays(n: int, seed: int = 7):
    """The airlines schema and signal of bench.py's CSV generator, as
    int columns plus categorical domains (no CSV file)."""
    r = np.random.RandomState(seed)
    carriers = ["UA", "AA", "DL", "WN", "US", "NW", "CO", "MQ"]
    origins = [f"{a}{b}{c}" for a in "ABCDE" for b in "AEIOU"
               for c in "KLMNP"]
    dep = r.randint(0, 2400, n)
    crs = np.maximum(dep - r.randint(-10, 60, n), 0)
    month = r.randint(1, 13, n)
    car_i = r.randint(0, len(carriers), n)
    delay = (0.03 * (dep - 1000) + np.isin(car_i, [0, 5]) * 15
             + np.isin(month, [12, 1, 6]) * 8 + r.randn(n) * 25)
    cols = {
        "Year": r.randint(1987, 2009, n), "Month": month,
        "DayofMonth": r.randint(1, 29, n), "DayOfWeek": r.randint(1, 8, n),
        "DepTime": dep, "CRSDepTime": crs, "UniqueCarrier": car_i,
        "Origin": r.randint(0, len(origins), n),
        "Dest": r.randint(0, len(origins), n),
        "Distance": r.randint(50, 2600, n),
        "IsDepDelayed": (delay > 15).astype(np.int32),
    }
    domains = {"UniqueCarrier": carriers, "Origin": origins,
               "Dest": origins, "IsDepDelayed": ["NO", "YES"]}
    return cols, domains


def dyadic_stats(n: int, seed: int, torch, device):
    """[n, 3] {w, w·g, w·h} with small-integer g, h: every float32 sum of
    up to 2^22 rows is exact in any order."""
    r = np.random.RandomState(seed)
    w = (r.rand(n) > 0.05).astype(np.float32)
    g = r.randint(-4, 5, n).astype(np.float32)
    h = r.randint(1, 5, n).astype(np.float32)
    return torch.from_numpy(np.stack([w, w * g, w * h], 1)).to(device)


def real_stats(n: int, seed: int, torch, device):
    r = np.random.RandomState(seed)
    g = r.uniform(-1, 1, n).astype(np.float32)
    h = r.uniform(0.05, 0.25, n).astype(np.float32)
    return torch.from_numpy(
        np.stack([np.ones(n, np.float32), g, h], 1)).to(device)


# ------------------------------------------------------------- helpers


def level_plan(bm, torch, device):
    """Per-level small operands of the flagship fit (no sampling)."""
    from h2o3_tpu_torch.models.tree import TreeParams, scalars_of
    tp = TreeParams(max_depth=6, min_rows=10.0, reg_lambda=0.0,
                    min_split_improvement=1e-5, nbins_total=bm.nbins_total,
                    cat_feats=tuple(bool(v) for v in bm.is_cat))
    sc = scalars_of(tp, device)
    is_cat = torch.tensor(tp.cat_feats, dtype=torch.bool, device=device)
    F = bm.bins.shape[1]
    inf = torch.full((1,), np.inf, dtype=torch.float32, device=device)
    return tp, sc, is_cat, torch.ones(F, dtype=torch.bool, device=device), \
        -inf, inf


def hist_tolerance(bins, nid, stats, d, Lh, B):
    """|kernel - plain| allowed per cell for real-valued stats: twice the
    float32 recursive-summation bound n·u·Σ|x| (u = 2^-24) of a cell of n
    rows — both sides sum the same rows in different orders. Returns
    (tolerance, Σ|x| per cell)."""
    import torch
    from h2o3_tpu_torch.ops.kernels.treekernel import hist_plain
    mass = hist_plain(bins, nid, stats.abs(), d=d, n_nodes_h=Lh, n_bins=B)
    n = hist_plain(bins, nid, torch.ones_like(stats), d=d, n_nodes_h=Lh,
                   n_bins=B)
    return 2.0 * n * 2.0 ** -24 * mass, mass


def compare_level(tk, bins, nid, stats, prev, ops, *, d, L, B, exact):
    """Hold the three kernels against their plain versions at one level.
    Returns (max_abs_err per kernel, split flips, plain outputs)."""
    import torch
    cm, nb, ic, cons, lo, hi, knobs, dl = ops
    Lh = max(L // 2, 1)
    errs = {}
    lh_p = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
    lh_k = tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
    torch.cuda.synchronize()
    errs["tree_hist"] = float((lh_k - lh_p).abs().max())
    if exact:
        check(torch.equal(lh_k, lh_p), f"tree_hist d={d} not exact")
    else:
        tol, mass = hist_tolerance(bins, nid, stats, d, Lh, B)
        diff = (lh_k - lh_p).abs()
        errs["tree_hist_rel"] = float((diff / mass.clamp_min(1e-30)).max())
        check(bool((diff <= tol).all()),
              f"tree_hist d={d} beyond the summation bound: max |diff| "
              f"{float(diff.max())}, max |diff|/bound "
              f"{float((diff / tol.clamp_min(1e-30)).max())}")
    out_p = tk.split_plain(lh_p, prev, cm, nb, ic, cons, lo, hi, knobs, dl,
                           d=d, n_nodes=L, n_bins=B)
    out_k = tk.tree_split(lh_p, prev, cm, nb, ic, cons, lo, hi, knobs, dl,
                          d=d, n_nodes=L, n_bins=B)
    torch.cuda.synchronize()
    names = ("hist", "gain", "feat", "thresh", "na_left", "left_val",
             "right_val", "leftmask", "split", "cat_split")
    flips = 0
    gk, gp = out_k[1], out_p[1]
    finite = torch.isfinite(gp)
    errs["tree_split"] = float((gk - gp)[finite].abs().max()) \
        if finite.any() else 0.0
    if exact:
        for nm, a, b in zip(names, out_k, out_p):
            check(torch.equal(a, b) or (a.dtype.is_floating_point and bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())),
                f"tree_split d={d} output {nm} not exact")
    else:
        check(torch.equal(out_k[0], out_p[0]), f"tree_split d={d} hist")
        same = (out_k[2] == out_p[2]) & (out_k[3] == out_p[3]) & \
            (out_k[4] == out_p[4])
        flips = int((~same).sum())
        # a flipped decision must be a near-tie: its gain equals the
        # plain best within float32 rounding of the prefix sums
        rel = ((gk - gp).abs() / gp.abs().clamp_min(1.0))[finite]
        check(bool((rel <= 1e-3).all()), f"tree_split d={d} gain rtol")
    # partition on the plain decisions, both ways: integer-exact
    dec = (out_p[2], out_p[3], out_p[4], out_p[8], out_p[9], out_p[7])
    new_p = tk.partition_plain(bins, nid, *dec, n_bins=B)
    new_k = tk.tree_partition(bins, nid, *dec, n_bins=B)
    torch.cuda.synchronize()
    errs["tree_partition"] = float((new_k - new_p).abs().max())
    check(torch.equal(new_k, new_p), f"tree_partition d={d} not exact")
    return errs, flips, out_p, new_p


def time_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# --------------------------------------------------------------- phases


def phase_toolchain(torch):
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    CARD = smi
    print(smi, flush=True)
    from h2o3_tpu_torch.ops import kernels
    nv = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | nvcc: {nv[-1]} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = kernels.build()
    say(f"kernels built in {time.perf_counter() - t0:.3f} s "
        f"({', '.join(kernels.sources())})")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "Compiling entry" in ln or \
                    "bytes stack" in ln:
                print(f"  ptxas[{name}] {ln.strip()}", flush=True)


def phase_kernels(torch, dev, bm):
    """Phase 2 at the flagship width; returns max |err| per kernel."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    B = bm.nbins_total
    bins = bm.bins[:N_KERNEL].contiguous()
    check(bins.dtype == torch.int8 and B == 126 and bins.shape[1] == 10,
          f"flagship bins int8 B=126 F=10, got {bins.dtype} {B} "
          f"{tuple(bins.shape)}")
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    worst = {"tree_hist": 0.0, "tree_split": 0.0, "tree_partition": 0.0}
    for label, stats, exact in (
            ("dyadic", dyadic_stats(N_KERNEL, 3, torch, dev), True),
            ("real", real_stats(N_KERNEL, 4, torch, dev), False)):
        nid = torch.zeros(N_KERNEL, dtype=torch.int32, device=dev)
        prev = None
        total_flips = 0
        for d in range(6):
            errs, flips, out_p, nid_next = compare_level(
                tk, bins, nid, stats, prev, ops, d=d, L=2 ** d, B=B,
                exact=exact)
            total_flips += flips
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            prev, nid = out_p[0], nid_next
            say(f"phase2 {label} d={d}: max|err| " + " ".join(
                f"{k}={v:.3g}" for k, v in errs.items()) +
                (f" split flips={flips}" if not exact else " exact"))
        if not exact:
            say(f"phase2 real-valued stats: {total_flips} split decision(s) "
                "differ from the plain version, each at a near-tie "
                "(gain within 1e-3 of max(|gain|, 1))")
    # depth bucket 10: Lh = 256 parents, the slab in node chunks
    r = np.random.RandomState(5)
    nid = torch.from_numpy(r.randint(0, 512, N_KERNEL).astype(np.int32)).to(dev)
    stats = dyadic_stats(N_KERNEL, 6, torch, dev)
    prev = tk.hist_plain(bins, nid >> 1, stats, d=0, n_nodes_h=256, n_bins=B)
    errs, _, _, _ = compare_level(tk, bins, nid, stats, prev, ops, d=9,
                                  L=512, B=B, exact=True)
    say("phase2 Lh=256 (d=9) exact: " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    # int32 bins at B = 200
    B2, F2 = 200, 10
    bins32 = torch.from_numpy(r.randint(0, B2, (N_KERNEL, F2)).astype(
        np.int32)).to(dev)
    nb2 = torch.full((F2,), B2 - 1, dtype=torch.int32, device=dev)
    ic2 = torch.tensor([i % 3 == 0 for i in range(F2)], device=dev)
    ops2 = tk.level_operands(torch.ones(F2, dtype=torch.bool, device=dev),
                             nb2, ic2, None, lo, hi, sc, dev)
    nid = torch.from_numpy(r.randint(0, 4, N_KERNEL).astype(np.int32)).to(dev)
    prev = tk.hist_plain(bins32, nid >> 1, stats, d=0, n_nodes_h=2,
                         n_bins=B2)
    errs, _, _, _ = compare_level(tk, bins32, nid, stats, prev, ops2, d=2,
                                  L=4, B=B2, exact=True)
    say("phase2 int32 bins B=200 (d=2) exact: " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    return worst


def phase_grow_tree(torch, dev, bm):
    from h2o3_tpu_torch.models.tree import Tree, grow_tree
    from h2o3_tpu_torch.ops.kernels.treekernel import plain_level
    tp, sc, _, cm, _, _ = level_plan(bm, torch, dev)
    st = dyadic_stats(N_KERNEL, 8, torch, dev)
    w = st[:, 0].contiguous()
    g = (st[:, 1] / torch.where(w > 0, w, 1.0)).contiguous()
    h = (st[:, 2] / torch.where(w > 0, w, 1.0)).contiguous()
    bins = bm.bins[:N_KERNEL].contiguous()
    t_k, nid_k, gain_k = grow_tree(bins, bm.nbins, w, g, h, cm, params=tp,
                                   scalars=sc)
    t_p, nid_p, gain_p = grow_tree(bins, bm.nbins, w, g, h, cm, params=tp,
                                   scalars=sc, level_fn=plain_level)
    torch.cuda.synchronize()
    for f in Tree._fields:
        check(torch.equal(getattr(t_k, f), getattr(t_p, f)),
              f"grow_tree field {f} differs kernels vs plain")
    check(torch.equal(nid_k, nid_p), "grow_tree leaf ids differ")
    check(torch.equal(gain_k, gain_p), "grow_tree gains differ")
    say(f"phase3 grow_tree depth {tp.max_depth}: kernels == plain, field "
        f"for field ({int(t_k.is_split.sum())} splits, "
        f"{int(t_k.cat_split.sum())} categorical)")


def phase_main(torch, dev, cols, domains):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    model = h2o.GBMEstimator(**FLAGSHIP).train(fr, y="IsDepDelayed")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t1 = time.perf_counter()
    pred = model.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t1
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    for k, v in counts.items():
        check(v == want, f"{k} launched {v} times on the main path, "
                         f"want {want}")
    tm = model.training_metrics
    p1 = pred.col("p1").host_view()
    check(p1.shape == (N_MAIN,) and np.isfinite(p1).all()
          and (p1 > 0).all() and (p1 < 1).all(), "p1 finite in (0, 1)")
    check(np.array_equal(pred.col("predict").host_view(),
                         (p1 >= model.output["default_threshold"])),
          "predict label = p1 >= threshold")
    check(np.isfinite(tm["AUC"]) and tm["AUC"] > 0.7,
          f"training AUC {tm['AUC']}")
    perf = model.model_performance(fr)
    check(abs(perf["AUC"] - tm["AUC"]) < 1e-9 and
          abs(perf["logloss"] - tm["logloss"]) < 1e-9,
          "model_performance on the training frame = training metrics")
    say(f"phase4 main path: GBM ntrees={FLAGSHIP['ntrees']} max_depth="
        f"{FLAGSHIP['max_depth']} on {N_MAIN} rows: train {t_train:.3f} s, "
        f"{N_MAIN * FLAGSHIP['ntrees'] / t_train:.6g} rows*trees/s, "
        f"predict {t_pred:.3f} s, AUC {tm['AUC']:.6f}, logloss "
        f"{tm['logloss']:.6f}, peak device memory {peak / 2**30:.3f} GiB")
    say(f"phase4 launches: {counts}")
    # the output against the CPU plain path on a small sample
    small = {k: v[:50_000] for k, v in cols.items()}
    m_gpu = h2o.GBMEstimator(**FLAGSHIP).train(
        h2o.Frame.from_numpy(small, domains=domains, device=dev),
        y="IsDepDelayed")
    m_cpu = h2o.GBMEstimator(**FLAGSHIP).train(
        h2o.Frame.from_numpy(small, domains=domains, device="cpu"),
        y="IsDepDelayed")
    d_auc = abs(m_gpu.training_metrics["AUC"] - m_cpu.training_metrics["AUC"])
    d_ll = abs(m_gpu.training_metrics["logloss"]
               - m_cpu.training_metrics["logloss"])
    agree = float((m_gpu.forest.feat.cpu() == m_cpu.forest.feat).float()
                  .mean())
    check(d_auc < 5e-3 and d_ll < 5e-3,
          f"50K-row fit card vs CPU: dAUC {d_auc} dlogloss {d_ll}")
    say(f"phase4 50K-row fit card vs CPU plain: |dAUC| {d_auc:.3g} "
        f"|dlogloss| {d_ll:.3g}, split features equal at {agree:.4f} of "
        "slots")
    return model, fr, counts


def phase_profile(torch, dev, fr):
    """Where the main path's time goes: the binning pass alone, then one
    more fit under torch.profiler (device time by kernel, host time by
    op, and the device's busy share of the fit's wall time)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from torch.profiler import ProfilerActivity, profile
    x = [c for c in fr.names if c != "IsDepDelayed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bin_frame(fr, x, nbins=64, nbins_cats=1024,
              weights=np.ones(fr.nrows, np.float32))
    torch.cuda.synchronize()
    say(f"phase4 profile: bin_frame alone {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h2o.GBMEstimator(**FLAGSHIP).train(fr, y="IsDepDelayed")
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in ev) / 1e3
    say(f"phase4 profile: fit under the profiler {wall:.1f} ms wall, "
        f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
    for e in sorted(ev, key=dev_us, reverse=True)[:10]:
        if dev_us(e) > 0:
            say(f"  device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                f"{e.key[:90]}")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        say(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")


def _hist_bytes(N, F, Lh, B, bin_bytes):
    return N * (F * bin_bytes + 4 + 12) + Lh * F * B * 12


def phase_timing(torch, dev, model, counts):
    """Kernel times at the main path's shapes, averaged over d=0..5."""
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    bm = model.bm
    bins = bm.bins
    N, F = bins.shape
    B = bm.nbins_total
    tp, sc, is_cat, cm, lo, hi = level_plan(bm, torch, dev)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    stats = dyadic_stats(N, 9, torch, dev)
    acc = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0) for k in counts}
    nid = torch.zeros(N, dtype=torch.int32, device=dev)
    prev = None
    levels = 6
    for d in range(levels):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        lh = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        out = tk.split_plain(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        n = nid.long()
        cell = (n[:, None] * F + torch.arange(F, device=dev)) * B \
            + bins.long()
        if d > 0:
            cell = torch.where((n % 2 == 0)[:, None],
                               ((n >> 1)[:, None] * F
                                + torch.arange(F, device=dev)) * B
                               + bins.long(), Lh * F * B)
        cell = cell.reshape(-1)
        src = stats[:, None, :].expand(N, F, 3).reshape(N * F, 3)
        slots = Lh * F * B + 1
        runs = {
            "tree_hist": (
                lambda: tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=Lh,
                                     n_bins=B),
                lambda: tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh,
                                      n_bins=B),
                lambda: torch.zeros((slots, 3), device=dev).index_add_(
                    0, cell, src)),
            "tree_split": (
                lambda: tk.tree_split(lh, prev, *ops, d=d, n_nodes=L,
                                      n_bins=B),
                lambda: tk.split_plain(lh, prev, *ops, d=d, n_nodes=L,
                                       n_bins=B),
                None),
            "tree_partition": (
                lambda: tk.tree_partition(bins, nid, *dec, n_bins=B),
                lambda: tk.partition_plain(bins, nid, *dec, n_bins=B),
                None),
        }
        ncat = int(is_cat.sum())
        bound_bytes = {
            "tree_hist": _hist_bytes(N, F, Lh, B, bins.element_size()),
            "tree_split": (Lh * F * B * 12 * (2 if d else 1)
                           + L * F * B * 12 + L * (B - 1) + L * 26),
            "tree_partition": N * (F * bins.element_size() + 4 + 4)
            + L * (B + 12),
        }
        bound_ops = {
            "tree_hist": 3 * N * F,
            # per (node, feature, threshold, direction) ~20 flops, plus
            # the categorical ranks' (B-1)^2 compares per (node, feature)
            "tree_split": L * F * (B - 1) * 2 * 20 + L * ncat * (B - 1) ** 2,
            "tree_partition": 4 * N,
        }
        for k, (kern, plain, lib) in runs.items():
            a = acc[k]
            ms = time_ms(torch, kern)
            say(f"  {k} d={d}: {ms:.6g} ms")
            a["ms"] += ms
            a["plain_ms"] += time_ms(torch, plain, reps=3)
            if lib is not None:
                a["library_ms"] += time_ms(torch, lib, reps=3)
            a["bytes_ms"] += bound_bytes[k] / HBM_BYTES_PER_S * 1e3
            a["ops_ms"] += bound_ops[k] / F32_OPS_PER_S * 1e3
        prev, nid = out[0], tk.partition_plain(bins, nid, *dec, n_bins=B)
        del cell, src
    records = []
    for k, a in acc.items():
        bound = max(a["bytes_ms"], a["ops_ms"])
        rec = {"name": k, "route": "cuda", "source": TREEKERNEL_SRC,
               "replaces": REPLACES, "launches": counts[k],
               "ms": a["ms"] / levels, "plain_ms": a["plain_ms"] / levels,
               "bound_ms": bound / levels,
               "bound_by": "bytes" if a["bytes_ms"] >= a["ops_ms"]
               else "operations",
               "library_ms": (a["library_ms"] / levels
                              if k == "tree_hist" else None)}
        records.append(rec)
        say(f"phase5 {k}: {rec['ms']:.6g} ms per launch (mean of d=0..5 at "
            f"{N} rows), plain {rec['plain_ms']:.6g} ms, bound "
            f"{rec['bound_ms']:.6g} ms ({rec['bound_by']}), library "
            f"{rec['library_ms']}")
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import h2o3_tpu_torch  # noqa: F401 - fails outside the repository
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    phase_toolchain(torch)

    from h2o3_tpu_torch.frame.binning import bin_frame
    import h2o3_tpu_torch as h2o
    cols, domains = airlines_arrays(N_MAIN)
    small = {k: v[:N_KERNEL] for k, v in cols.items()}
    fr_k = h2o.Frame.from_numpy(small, domains=domains, device=dev)
    x = [c for c in cols if c != "IsDepDelayed"]
    bm = bin_frame(fr_k, x, nbins=64, nbins_cats=1024)

    worst = phase_kernels(torch, dev, bm)
    phase_grow_tree(torch, dev, bm)
    del fr_k, bm
    model, fr, counts = phase_main(torch, dev, cols, domains)
    phase_profile(torch, dev, fr)
    records = phase_timing(torch, dev, model, counts)
    for rec in records:
        rec["max_abs_err"] = worst[rec["name"]]
    say(f"chip_smoke total {time.perf_counter() - t_all:.3f} s")
    print(CARD, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
