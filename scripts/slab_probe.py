#!/usr/bin/env python3
"""Build the slab histogram (``h2o3_tpu_torch/ops/kernels/csrc/
hist_slab.cuh``), hold it against its plain version at the main paths'
widths, and time it under other launch plans on the same inputs.

    python3 scripts/slab_probe.py      # from the repository root, one card
    python3 scripts/slab_probe.py --ab ROOT_A ROOT_B [--half-a] [--rounds R]

Prints the card's name and power limit, the ``-Xptxas -v`` report of
``slab_hist_kernel``, then per launch plan (threads per block, the slab
budget, blocks per SM slot) the ms a launch of ``tree_hist`` at each level
d = 0..9 of the 5M-row airlines frame (GBM's levels d = 0..5, DRF's to
d = 9) and of ``histogram`` at each level d = 0..9 of the 13,979,592-row
Criteo-schema uplift frame, each output EXACTLY equal to the plain
version (dyadic and 0/1 stats). Plans run in turns (A, B, ..., A) so
drift shows. Last, the load side of the row scan at the uplift frame's
level 0 two ways (``scripts/slab_staging.cu``): unrolled loads, as the
kernel has them, against tiles staged into shared memory by the bulk
asynchronous copy, in turns.

``--ab`` times ``tree_hist`` of two checkouts on one card: what a change
of the slab histogram costs, and why. ROOT is a directory that holds
only an ``h2o3_tpu_torch/`` (another commit's, unpacked by ``git archive
<commit> h2o3_tpu_torch`` into a gitignored directory) or the repository
itself; the data, levels and timer come from this repository's
``chip_smoke.py``. Each run, in a process of its own, builds ROOT's
kernels, makes the 5,000,000-row airlines frame's bins and the node ids
of the flagship's levels d = 0..5 (the plain level chain on dyadic
stats, as ``chip_smoke.level_timing``), holds ``tree_hist`` EXACT
against its plain version at each level and times it with
``chip_smoke.time_ms`` (device ms, L2 flushed; the fixed-point
exponents, where the checkout takes them, computed once outside the
timed call, as a fit has them once a tree). The runs go A B B A,
``--rounds`` times; ``--half-a`` adds ROOT_A at the slab budget whose
room beside the row queues is half the default: a kernel of 4-byte
cells then gets the node chunks and slab copies that one of 8-byte cells
gets at the full budget, which separates the cost of the wider cells'
atomics from that of the plan. The last line is one JSON object with
every number. Exits non-zero on any mismatch or without a card."""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
QUEUE_BYTES = 1024 // 32 * 32 * 4    # the warps' row queues a block

# (label, threads, slab budget bytes, waves): one 1024-thread block per
# SM, or two 512-thread blocks with half the slab each
PLANS = [("1x1024", 1024, 232_448, 1), ("2x512", 512, 115_712, 1),
         ("1x1024 waves=2", 1024, 232_448, 2),
         ("1x1024 again", 1024, 232_448, 1)]


def gbm_levels(torch, cs, dev, n_rows, depth=10):
    """Airlines bins of the first ``n_rows`` rows and, per level
    d < depth, the node ids of the plain level chain on dyadic stats (as
    chip_smoke's level timing)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    cols, domains = cs.airlines_arrays(cs.N_MAIN)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    bm = bin_frame(fr, [c for c in cols if c != "IsDepDelayed"], nbins=64,
                   nbins_cats=1024)
    bins, B = bm.bins[:n_rows].contiguous(), bm.nbins_total
    _, sc, is_cat, cm, lo, hi = cs.level_plan(bm, torch, dev,
                                              max_depth=depth)
    ops = tk.level_operands(cm, bm.nbins, is_cat, None, lo, hi, sc, dev)
    stats = cs.dyadic_stats(bins.shape[0], 9, torch, dev)
    nid = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
    prev, levels = None, []
    for d in range(depth):
        L, Lh = 2 ** d, max(2 ** d // 2, 1)
        lh = tk.hist_plain(bins, nid, stats, d=d, n_nodes_h=Lh, n_bins=B)
        levels.append((nid, Lh, lh))
        out = tk.split_plain(lh, prev, *ops, d=d, n_nodes=L, n_bins=B)
        dec = (out[2], out[3], out[4], out[8], out[9], out[7])
        prev, nid = out[0], tk.partition_plain(bins, nid, *dec, n_bins=B)
    return bins, B, stats, levels


def uplift_levels(torch, cs, dev):
    """Criteo-schema bins, the treated arm's stats and, per level, the
    node ids of a one-tree uplift fit (as chip_smoke phase 9)."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.gbm import tree_generator
    from h2o3_tpu_torch.models.tree import Tree, _route
    from h2o3_tpu_torch.ops.histogram import local_histogram
    cols, domains = cs.criteo_arrays(cs.N_UPLIFT)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    model = h2o.UpliftDRFEstimator(**dict(cs.UPLIFT, ntrees=1)).train(
        fr, y="visit")
    bins, B = model.bm.bins, model.bm.nbins_total
    N = bins.shape[0]
    D = cs.UPLIFT["max_depth"]
    leaf = _route(Tree(*(a[0] for a in model.forest)), bins, B)
    gen = tree_generator(cs.UPLIFT["seed"], 0, dev)
    keep = torch.rand(N, generator=gen, device=dev) < cs.UPLIFT["sample_rate"]
    w = fr.valid_weights() * keep * fr.col("treatment").data
    y = fr.col("visit").data.to(torch.float32)
    stats = torch.stack([w, w * y, w], dim=1).contiguous()
    levels = []
    for d in range(D):
        nid = (leaf >> (D - d)).to(torch.int32).contiguous()
        levels.append((nid, 2 ** d, local_histogram(
            bins, nid, stats, n_nodes=2 ** d, n_bins=B)))
    return bins, B, stats, levels


def staging(torch, kernels, card, bins_stats):
    """Time scripts/slab_staging.cu's two row scans (unrolled, staged) on
    the uplift frame's level-0 node ids and stats, in turns."""
    import ctypes
    src = Path(__file__).with_name("slab_staging.cu")
    out = kernels.BUILD / "libslab_staging.so"
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc(), *kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.slab_scan.argtypes = [ctypes.c_int, vp, vp, ll, ll, ctypes.c_int,
                              vp, vp]
    nid, stats = bins_stats
    n = nid.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = int(((stats != 0).any(1) & (nid == 0)).sum())
    counted = torch.zeros(1, dtype=torch.int64, device=nid.device)
    stream = torch.cuda.current_stream().cuda_stream

    def scan(staged):
        per = -(-n // sms)
        if staged:
            per = -(-per // 1024) * 1024
        counted.zero_()
        rc = lib.slab_scan(staged, nid.data_ptr(), stats.data_ptr(), n, per,
                           1, counted.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"slab_scan staged={staged} failed: {rc}")

    times = {}
    for staged in (0, 1, 1, 0):
        scan(staged)
        torch.cuda.synchronize()
        if int(counted) != want:
            raise RuntimeError(f"slab_scan staged={staged} counted "
                               f"{int(counted)} rows, want {want}")
        import chip_smoke as cs
        times.setdefault(staged, []).append(cs.time_ms(
            torch, lambda: scan(staged), reps=20)["ms"])
    print(f"row scan at {n} rows (level 0, {want} rows count): unrolled "
          f"loads {times[0][0]:.4f} / {times[0][1]:.4f} ms, staged "
          f"(cp.async.bulk, two-stage ring) {times[1][0]:.4f} / "
          f"{times[1][1]:.4f} ms [{card}]", flush=True)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def one_run(root: str, budget) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    import chip_smoke as cs
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    if not torch.cuda.is_available():
        raise SystemExit("slab_probe: no CUDA device")
    kernels.build(["treekernel"])
    if budget is not None:
        tk.HIST_SLAB_BYTES = int(budget)
    dev = torch.device("cuda")
    cols, domains = cs.airlines_arrays(cs.N_MAIN)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    bm = bin_frame(fr, [c for c in cols if c != "IsDepDelayed"], nbins=64,
                   nbins_cats=1024)
    bins, B = bm.bins, bm.nbins_total
    takes_exps = "exps" in inspect.signature(tk.tree_hist).parameters
    kw, ms = {}, []
    for lev in cs.level_chain(torch, bm, bins.shape[0], 6):
        d, Lh, nid, stats = lev["d"], lev["Lh"], lev["nid"], lev["stats"]
        if takes_exps and not kw:
            from h2o3_tpu_torch.ops.fixed_point import exponents
            kw["exps"] = exponents(stats)

        def call():
            return tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=Lh,
                                n_bins=B, **kw)
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, lev["lh"]):
            raise SystemExit(f"slab_probe: {root} d={d} not exact")
        ms.append(cs.time_ms(torch, call, reps=20)["ms"])
    plans = [kernels.slab_geometry(bins.shape[0], bins.shape[1],
                                   max(2 ** d // 2, 1), B,
                                   sms=kernels.sm_count(dev),
                                   budget=tk.HIST_SLAB_BYTES)
             for d in range(6)]
    return dict(root=root, budget=tk.HIST_SLAB_BYTES, ms=ms,
                mean_ms=float(np.mean(ms)),
                chunks=[p.n_chunks for p in plans],
                replicas=[p.replicas for p in plans])


def ab(argv, card) -> int:
    """``--ab``: ROOT_A and ROOT_B in turns (see the module's doc)."""
    args = argv[1:]
    half = "--half-a" in args
    rounds = int(args[args.index("--rounds") + 1]) \
        if "--rounds" in args else 1
    roots = [a for a in args if not a.startswith("--")
             and not a.isdigit()][:2]
    default = 232_448
    configs = [(roots[0], None), (roots[1], None)]
    if half:
        configs.append(
            (roots[0], (default - QUEUE_BYTES) // 2 + QUEUE_BYTES))
    order = []
    for r in range(rounds):
        order += configs + configs[::-1]
    runs = []
    for root, budget in order:
        out = subprocess.run(
            [sys.executable, __file__, "--one", root]
            + ([] if budget is None else [str(budget)]),
            capture_output=True, text=True, env=dict(os.environ))
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], flush=True)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(rec)
        print(f"{rec['root']} budget {rec['budget']}: tree_hist ms by "
              f"level " + " ".join(f"{t:.4f}" for t in rec["ms"])
              + f" | mean {rec['mean_ms']:.4f} | chunks "
              f"{rec['chunks']} replicas {rec['replicas']} [{card}]",
              flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("slab_probe: no CUDA device is available", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(one_run(argv[1], argv[2] if len(argv) > 2
                                 else None)), flush=True)
        return 0
    if argv[:1] == ["--ab"]:
        return ab(argv, card_name())
    import chip_smoke as cs
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.kernels import histogram as kh
    from h2o3_tpu_torch.ops.kernels import treekernel as tk
    card = card_name()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"built in {time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in logs.items():
        keep = False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                keep = "slab_hist_kernel" in ln
            if keep:
                print(f"  ptxas[{name}] {ln.strip()}", flush=True)
    dev = torch.device("cuda")
    # tree_hist at the GBM frame's rows and at one of two ranks' rows (the
    # shapes of shard_hist, which launches the same device code)
    paths = {"tree_hist": gbm_levels(torch, cs, dev, cs.N_MAIN),
             f"tree_hist at {cs.N_MAIN // 2} rows": gbm_levels(
                 torch, cs, dev, cs.N_MAIN // 2),
             "histogram": uplift_levels(torch, cs, dev)}
    sms = kernels.sm_count(dev)

    def launch(name, bins, B, stats, nid, n, d):
        if name.startswith("tree_hist"):
            return tk.tree_hist(bins, nid, stats, d=d, n_nodes_h=n, n_bins=B)
        return kh.full_histogram(bins, nid, stats, n_nodes=n, n_bins=B)

    for label, threads, budget, waves in PLANS:
        kernels.SLAB_THREADS, kernels.SLAB_WAVES = threads, waves
        tk.HIST_SLAB_BYTES = kh.HIST_SLAB_BYTES = budget
        for name, (bins, B, stats, levels) in paths.items():
            times = []
            for d, (nid, n, want) in enumerate(levels):
                got = launch(name, bins, B, stats, nid, n, d)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    print(f"{label} {name} d={d}: NOT EXACT, max |err| "
                          f"{float((got - want).abs().max())}", flush=True)
                    return 1
                times.append(cs.time_ms(torch, lambda: launch(
                    name, bins, B, stats, nid, n, d), reps=20)["ms"])
            plan = [kernels.slab_geometry(bins.shape[0], bins.shape[1], n,
                                          B, sms=sms) for _, n, _ in levels]
            print(f"{label} {name} exact at d=0..9; ms by level "
                  + " ".join(f"{t:.4f}" for t in times)
                  + f" | mean d=0..5 {np.mean(times[:6]):.4f}, d=6..9 "
                  f"{np.mean(times[6:]):.4f}, d=0..9 {np.mean(times):.4f} "
                  f"| chunks {[p.n_chunks for p in plan]} replicas "
                  f"{[p.replicas for p in plan]} row blocks "
                  f"{[p.row_blocks for p in plan]} [{card}]", flush=True)
    bins, B, stats, levels = paths["histogram"]
    staging(torch, kernels, card, (levels[0][0], stats))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
