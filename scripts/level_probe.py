#!/usr/bin/env python3
"""Time one checkout's ``tree_split`` and ``tree_partition`` kernels, and
its train seconds, on one card.

    python3 scripts/level_probe.py [ROOT]                 # kernels, fits
    python3 scripts/level_probe.py --mesh K ROOT [ROOT ...]

``h2o3_tpu_torch`` is imported from ROOT: the repository by default, or
a directory that holds only another ``h2o3_tpu_torch/`` (another
commit's, unpacked by ``git archive <commit> h2o3_tpu_torch`` into a
gitignored directory, or a variant copy), which compares two designs on
one card: run parent, change, change, parent. Everything else comes from
this repository's ``chip_smoke.py``.

The first form builds ROOT's kernels (printing ptxas' register lines),
then runs ``chip_smoke.level_timing`` on the 5,000,000-row airlines frame
for ``tree_split`` and ``tree_partition`` at the GBM levels d = 0..5 and
the DRF levels d = 6..9 (per-node mtries masks), for ``shard_partition``
on one rank's 2,500,000 rows at d = 0..5, and ``tree_split``'s floor
(L = 1, F = 1, B = 3), each output EXACT against its plain version and
each time as ``chip_smoke.time_ms`` gives it: device ms, host-paced ms
and the wrapper's host µs a call. Then it trains the flagship GBM and the
DRF twice each (host clock around ``train``, ending in ``synchronize``).

The second form runs ``chip_smoke.py``'s phases 10-11 (two ranks: the
sharded level held EXACT, then the flagship GBM over the mesh) K times
for each ROOT, the ROOTs taking turns (in reverse every other round),
and prints each rank's train seconds and the host seconds inside its
all-reduces, then per ROOT their medians and quartiles.

The last line is one JSON object with every number. Exits non-zero on a
mismatch or without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def kernel_times(torch, cs, card):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.ops import kernels
    for ln in kernels.build(["treekernel"]).get("treekernel", "").splitlines():
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
            print(f"  ptxas {ln.strip()}", flush=True)
    dev = torch.device("cuda")
    cols, domains = cs.airlines_arrays(cs.N_MAIN)
    fr = h2o.Frame.from_numpy(cols, domains=domains, device=dev)
    bm = bin_frame(fr, [c for c in cols if c != "IsDepDelayed"], nbins=64,
                   nbins_cats=1024)
    del cols
    res = {}
    level_kernels = ("tree_split", "tree_partition")
    for path, names, n_rows, depths, mtries in (
            ("gbm", level_kernels, cs.N_MAIN, range(6), None),
            ("drf", level_kernels, cs.N_MAIN, cs.DRF_DEPTHS,
             int(np.sqrt(bm.bins.shape[1]))),
            ("gbm_mesh", ("shard_partition",), cs.N_MAIN // cs.W_MESH,
             range(6), None)):
        acc = cs.level_timing(torch, dev, bm, names, n_rows, depths,
                              mtries=mtries)
        for name, a in acc.items():
            t = {k: a[k] / len(depths)
                 for k in ("ms", "host_paced_ms", "host_us")}
            res[f"{name} {path}"] = t
            print(f"{name} {path} mean over d={depths[0]}..{depths[-1]}: "
                  f"device {t['ms']:.6g} ms, host-paced "
                  f"{t['host_paced_ms']:.6g} ms, host {t['host_us']:.4g} us "
                  f"[{card}]", flush=True)
    res["tree_split floor"] = t = cs.split_floor_ms(torch, dev, bm)
    print(f"tree_split floor: device {t['ms']:.6g} ms, host-paced "
          f"{t['host_paced_ms']:.6g} ms, host {t['host_us']:.4g} us", flush=True)
    for est, kw in ((h2o.GBMEstimator, cs.FLAGSHIP), (h2o.DRFEstimator,
                                                      cs.DRF)):
        secs = res.setdefault(f"{est.__name__} train_s", [])
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est(**kw).train(fr, y="IsDepDelayed")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(f"{est.__name__} train seconds {secs} [{card}]", flush=True)
    return res


def mesh_times(torch, cs, roots, k, card):
    res = {str(r): {"train_s": [], "all_reduce_s": []} for r in roots}
    for i in range(k):
        # ABBA: every other round runs the ROOTs in reverse
        for root in roots if i % 2 == 0 else roots[::-1]:
            sys.path.insert(0, str(root))  # the ranks inherit sys.path
            try:
                with tempfile.TemporaryDirectory() as out_dir:
                    ranks, _, _ = cs.spawn_ranks(torch, out_dir)
            finally:
                sys.path.remove(str(root))
            train = [r["t_train"] for r in ranks]
            coll = [r["collectives"]["seconds"] for r in ranks]
            res[str(root)]["train_s"] += train
            res[str(root)]["all_reduce_s"] += coll
            print(f"mesh round {i} {root}: train seconds a rank {train}, "
                  f"all-reduce seconds {coll}", flush=True)
    for root, r in res.items():
        rest = np.subtract(r["train_s"], r["all_reduce_s"])
        for name, xs in (("train", r["train_s"]),
                         ("all-reduce", r["all_reduce_s"]),
                         ("train less all-reduce", rest)):
            q1, med, q3 = np.percentile(xs, [25, 50, 75])
            print(f"mesh {root}: {name} seconds a rank, median {med:.6g} "
                  f"(quartiles {q1:.6g}-{q3:.6g}) over {len(xs)} [{card}]",
                  flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("level_probe: no CUDA device is available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    k = 0
    if args[:1] == ["--mesh"]:
        k, args = int(args[1]), args[2:]
    roots = [Path(a).resolve() for a in args] or [REPO]
    for root in roots:  # the ranks must import this chip_smoke.py
        if root != REPO and (root / "chip_smoke.py").exists():
            print(f"level_probe: {root} holds a chip_smoke.py",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.CARD = card
    print(f"level_probe {[str(r) for r in roots]} [{card}]", flush=True)
    if k:
        res = mesh_times(torch, cs, roots, k, card)
    else:
        sys.path.insert(0, str(roots[0]))
        import h2o3_tpu_torch as h2o
        cs.check(Path(h2o.__file__).resolve().is_relative_to(roots[0]),
                 f"h2o3_tpu_torch imported from {h2o.__file__}, not "
                 f"{roots[0]}")
        res = kernel_times(torch, cs, card)
    print(json.dumps({"card": card, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
