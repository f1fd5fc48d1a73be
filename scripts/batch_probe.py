#!/usr/bin/env python3
"""Where a batched GBM bucket's time goes on one card, at bench.py's grid
(500K x 6 numeric rows, 16 GBM combos of 20 trees at depth 6: one shape
bucket, as ``chip_smoke.py`` phase 27(a) trains it).

    python3 scripts/batch_probe.py

Builds the kernels, fits the bucket once through ``fit_gbm_batched`` to
warm up, times a second fit, then runs a third under cProfile and prints
the functions by cumulative host time (the fit is host-paced: a batched
level is ~0.3 ms on the card). Exits non-zero without a card."""

from __future__ import annotations

import cProfile
import itertools
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("batch_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.gbm import fit_gbm_batched
    from h2o3_tpu_torch.ops import kernels
    kernels.build()
    dev = torch.device("cuda")
    fr = h2o.Frame.from_numpy(cs.grid_arrays(), domains={"y": ["N", "Y"]},
                              device=dev)
    names = sorted(cs.GRID_HYPER)
    plist = [{**cs.GRID_FIXED, **dict(zip(names, v))}
             for v in itertools.product(*(cs.GRID_HYPER[n] for n in names))]

    def fit():
        fit_gbm_batched(h2o.GBMEstimator, plist, fr, y="y")
        torch.cuda.synchronize()

    fit()
    t0 = time.perf_counter()
    fit()
    secs = time.perf_counter() - t0
    print(f"{torch.cuda.get_device_name(0)}: {len(plist)} models in "
          f"{secs:.3f} s, {len(plist) / secs:.6g} models/s", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    fit()
    prof.disable()
    pstats.Stats(prof).sort_stats("cumtime").print_stats(30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
