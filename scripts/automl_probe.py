#!/usr/bin/env python3
"""Where an AutoML model's time goes on one card, at bench.py's AutoML
frame (500K airlines rows from CSV, as ``chip_smoke.py`` phase 27 reads
them).

    python3 scripts/automl_probe.py

Builds the kernels, then times a GBM (100 trees, depth 6, AutoML's row
and column sampling) without and with a ``max_runtime_secs`` cap (the
cap waits for the card after every tree), with early stopping, with
3-fold CV, and a depth-20 GBM of XGBoost_2's shape (10 trees), each
twice where noted; then runs a 3-tree depth-20 fit and a 20-tree
depth-6 fit under ``torch.profiler`` and prints each one's kernels by
device time and the host's launches a tree. Exits non-zero without a
card."""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("automl_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_toolchain(torch)
    import h2o3_tpu_torch as h2o
    fr = cs.automl_frame(torch, dev)
    y = cs.Y

    def timed(label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = h2o.GBMEstimator(**kw).train(fr, y=y)
        torch.cuda.synchronize()
        cs.say(f"{label}: {time.perf_counter() - t0:.3f} s, "
               f"{m.forest.feat.shape[0]} trees")

    base = dict(ntrees=100, max_depth=6, seed=1, sample_rate=0.8,
                col_sample_rate_per_tree=0.8)
    deep = dict(max_depth=20, min_rows=10.0, seed=1, sample_rate=0.6,
                col_sample_rate_per_tree=0.8)
    for _ in range(2):
        timed("GBM 100 trees, depth 6", **base)
        timed("GBM 100 trees, depth 6, capped at 1000 s",
              max_runtime_secs=1000.0, **base)
    timed("GBM 100 trees, depth 6, stopping_rounds 3 every 5 trees",
          stopping_rounds=3, score_tree_interval=5, **base)
    timed("GBM 100 trees, depth 6, stopping, nfolds 3", nfolds=3,
          stopping_rounds=3, score_tree_interval=5, **base)
    timed("GBM 10 trees, depth 20 (XGBoost_2's shape)", ntrees=10, **deep)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for label, kw, ntrees in (("depth 20", deep, 3),
                              ("depth 6", base, 20)):
        with torch.profiler.profile(activities=act) as prof:
            timed(f"GBM {ntrees} trees, {label}, profiled",
                  **dict(kw, ntrees=ntrees))
        ka = prof.key_averages()
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        cs.say(f"{label}: {launches / ntrees:.0f} kernel launches a tree")
        print(ka.table(sort_by="cuda_time_total", row_limit=12), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
