#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s DeepLearning card-vs-CPU
limits, on one card.

    python3 scripts/dl_limits.py

Runs ``chip_smoke.dl_card_vs_cpu`` over every card-vs-CPU DL fit that
``chip_smoke.py`` phase 23 and the ``gpu`` tests of
``tests/test_torch_cuda.py`` hold, each sound and with a control: the
float32 fits with TF32 on the card (``dl_tf32_control``), the bf16 fits
with bf16-rounded products (``dl_bf16_rounded_control``). A limit is
sound where every sound fit reads below it and every control above it.
For each fit it prints the largest pre-activation gap over its float32
bound (held at 1), the step reading (``held``: the largest step gap
held against DL_STEP_TOL or DL_BF16_STEP_TOL, a flip step's without its
tied rows), the flips, the replayed fits' weight and score gaps (held
only for float32 products where nothing flipped), and the estimator
fits' gaps on their own designs (held by no limit); then per limit the
largest sound and the smallest control reading.

The last line is one JSON object with every reading. Exits non-zero
without a card, or where a sound fit is not correct or a control is."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def cases(mcols, mdoms, acols, adoms, delay):
    """(label, columns, domains, response, parameters, x) of each held
    fit, as phase 23 and the ``gpu`` tests build them."""
    def head(cols, n):
        return {k: v[:n] for k, v in cols.items()}
    ax = [c for c in acols if c not in (cs.Y, "delay", "late")]
    out = [
        ("23b head", head(mcols, cs.N_DL_HEAD), mdoms, "label",
         dict(cs.DL, epochs=1.0), None),
        ("23c head bf16", mcols, mdoms, "label",
         dict(cs.DL, epochs=2.0, mini_batch_size=cs.DL_BF16_BATCH), None),
        ("gpu rectifier", head(mcols, 8192), mdoms, "label",
         dict(cs.DL, epochs=1.0), None),
        ("gpu bf16", head(mcols, 32768), mdoms, "label",
         dict(cs.DL, epochs=1.0, mini_batch_size=cs.DL_BF16_BATCH), None),
        ("gpu maxout_nesterov", head(acols, 10000), adoms, "late",
         dict(cs.DL_SURFACE, activation="Maxout", adaptive_rate=False,
              rate=0.002, momentum_start=0.5, momentum_stable=0.9,
              momentum_ramp=2e4, l2=1e-4), ax)]
    for label, y, params, held in cs.dl_surface_fits(delay):
        if held:
            out.append((f"23d {label}", acols, adoms, y,
                        dict(cs.DL_SURFACE, **params), ax))
    out.append(("23d cv (main model)", acols, adoms, cs.Y,
                dict(cs.DL_SURFACE, activation="Tanh", nfolds=3), ax))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dl_limits: no CUDA device is available", file=sys.stderr)
        return 2
    import h2o3_tpu_torch as h2o
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(cs.CARD, flush=True)
    dev = torch.device("cuda")
    mcols, mdoms = cs.mnist_shape_arrays(cs.N_DL_BF16_HEAD)
    acols, adoms = cs.airlines_arrays(cs.N_DL_SURFACE)
    delay = cs.airlines_delay(cs.N_DL_SURFACE)
    acols["delay"] = delay
    acols["late"] = np.digitize(delay, [0.0, 15.0]).astype(np.int32)
    adoms = dict(adoms, late=["l0_early", "l1_ontime", "l2_late"])
    rows, bad = [], []
    for label, cols, doms, y, params, x in cases(mcols, mdoms, acols,
                                                 adoms, delay):
        bf16 = "mini_batch_size" in params
        kinds = [("sound", None)]
        if "cv" not in label:
            kinds.append(("bf16-rounded", cs.dl_bf16_rounded_control)
                         if bf16 else ("TF32", cs.dl_tf32_control))
        for kind, control in kinds:
            t0 = time.perf_counter()

            def run():
                return cs.dl_card_vs_cpu(
                    lambda: h2o.DeepLearningEstimator(**params), cols, doms,
                    y, dev, f"{label} [{kind}]", x=x)
            if control is None:
                res = run()
            else:
                with control(torch):
                    res = run()
            if res["ok"] != (control is None):
                bad.append(res["label"])
            print(f"{res['label']}: ok={res['ok']} "
                  f"({time.perf_counter() - t0:.2f} s) {cs.dl_report(res)}"
                  f"; why {res['why'][:3]}", flush=True)
            rows.append(dict(
                label=label, kind=kind, bf16=bf16, ok=res["ok"],
                held=res["held"], flips=len(res["flips"]),
                first_flip=res["flips"][0] if res["flips"] else None,
                z_ratio=res["z_ratio"], gap=res["gap"], p_gap=res["p_gap"],
                own_gap=res["own_gap"], own_p_gap=res["own_p_gap"],
                score_gap=res["score_gap"], mse_gap=res["mse_gap"]))
    limits = {}
    # (limit, fits: float32, bf16 or both, reading, fits without a flip
    # only, the controls that reach it: scoring runs in float32, so the
    # bf16-rounded products never reach DL_SCORE_TOL)
    for name, bf16, key, whole, controls in (
            ("the float32 bound (1)", None, "z_ratio", False, None),
            ("DL_STEP_TOL", False, "held", False, None),
            ("DL_BF16_STEP_TOL", True, "held", False, None),
            ("DL_TOL", False, "gap", True, None),
            ("DL_PROB_TOL", False, "p_gap", True, None),
            ("DL_SCORE_TOL", None, "score_gap", False, "TF32")):
        sel = [r for r in rows if bf16 in (None, r["bf16"])
               and not (whole and r["flips"])]
        sound = [r[key] for r in sel if r["kind"] == "sound"]
        ctl = [r[key] for r in sel if r["kind"] != "sound"
               and controls in (None, r["kind"])]
        limits[name] = dict(
            limit=getattr(cs, name.split()[0], 1),
            largest_sound=max(sound) if sound else None,
            smallest_control=min(ctl) if ctl else None)
        print(f"{name} = {limits[name]['limit']}: largest sound "
              f"{limits[name]['largest_sound']}, smallest control "
              f"{limits[name]['smallest_control']}"
              + (" (fits without a flip)" if whole else ""),
              flush=True)
    print(json.dumps({"card": cs.CARD, "fits": rows, "limits": limits,
                      "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
