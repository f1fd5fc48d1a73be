#!/usr/bin/env python3
"""The float32-order witnesses behind ``chip_smoke.py`` phase 24's
card-vs-CPU choices, on the CPU.

    python3 scripts/unsup_witness.py

Fits each configuration twice on the CPU plain path, on the first
N_UNSUP_CPU airlines rows in order and with the rows permuted, and
prints how far the two fits part: what float32 summation order alone
moves. No card is used and nothing here is a device measurement.

- SVD on the raw airlines columns (transform "none") and standardized:
  the singular values' relative gaps and |Δλ| / λ1 (why phase 24
  standardizes its SVD);
- GLRM at phase 24's settings (SVD init), with L1 and NonNegative on x
  (Random init), and NonNegative on both sides: steps, the objective's
  relative gap, A·Y's and the archetypes' gaps relative to
  max(1, |value|) (why GLRM_AY_TOL is 3e-2, and why the phase runs
  NonNegative on x only).

The last line is one JSON object with every reading."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import h2o3_tpu_torch as h2o  # noqa: E402


def permuted_pair(cols, domains, n: int, seed: int = 1):
    """The first ``n`` rows as a CPU frame in order and permuted, and
    the permutation."""
    head = {k: v[:n] for k, v in cols.items()}
    perm = np.random.default_rng(seed).permutation(n)
    return (h2o.Frame.from_numpy(head, domains=domains, device="cpu"),
            h2o.Frame.from_numpy({k: v[perm] for k, v in head.items()},
                                 domains=domains, device="cpu"), perm)


def svd_witness(cols, domains, n: int) -> dict:
    x_only = {k: v for k, v in cols.items() if k != cs.Y}
    a, b, _ = permuted_pair(x_only, domains, n)
    out = {}
    for transform in ("none", "standardize"):
        da, db = (np.asarray(h2o.SVDEstimator(nv=10, transform=transform)
                             .train(f).output["d"]) for f in (a, b))
        out[transform] = dict(
            d=da.tolist(), rel_gap=(np.abs(da - db) / db).tolist(),
            lam_gap_over_lam1=(np.abs(da ** 2 - db ** 2)
                               / db[0] ** 2).tolist())
    return out


def glrm_witness(cols, domains, n: int) -> dict:
    g = cs.glrm_columns(cols, n)
    a, b, perm = permuted_pair(g, domains, n)
    inv = np.argsort(perm)
    fits = [("quadratic (SVD init)", dict(cs.GLRM))]
    fits += [(label, dict(cs.GLRM, init="Random", seed=3, **params))
             for label, params in cs.GLRM_HEAD_FITS]
    fits.append(("NonNegative on both sides", dict(
        cs.GLRM, init="Random", seed=3, regularization_x="NonNegative",
        regularization_y="NonNegative")))
    out = {}
    for label, kw in fits:
        ma, mb = (h2o.GLRMEstimator(**kw).train(f) for f in (a, b))
        Ya, Yb = (np.asarray(m.output["archetypes"]).T for m in (ma, mb))
        out[label] = dict(
            steps=[ma.output["iterations"], mb.output["iterations"]],
            objective=cs.rel_gap(mb.output["objective"],
                                 ma.output["objective"]),
            AY=cs.rel_gap(cs.reconstruction(mb, b)[inv],
                          cs.reconstruction(ma, a), 1.0),
            Y=cs.rel_gap(cs.signed_like(Yb, Ya), Ya, 1.0))
    return out


def main() -> int:
    torch.set_num_threads(1)
    n = cs.N_UNSUP_CPU
    cols, domains = cs.airlines_arrays(n)
    res = {"rows": n, "svd": svd_witness(cols, domains, n),
           "glrm": glrm_witness(cols, domains, n)}
    for transform, r in res["svd"].items():
        print(f"SVD transform={transform}: d relative gaps "
              f"{np.array2string(np.asarray(r['rel_gap']), precision=3)}; "
              f"|dλ|/λ1 max {max(r['lam_gap_over_lam1']):.3g}")
    for label, r in res["glrm"].items():
        print(f"GLRM {label}: steps {r['steps']}, objective "
              f"{r['objective']:.3g}, A·Y {r['AY']:.3g}, archetypes "
              f"{r['Y']:.3g}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
