"""Row-payload parsing for the serving fast path.

Reference: h2o3_tpu/serving/rows.py. The row payload carries inline
JSON rows, no DKV frame round trip. This module turns those rows into
host numpy columns already adapted to the model's training schema (the
adaptTestForTrain role, hex/Model.java:1850, applied at parse time):
categorical values map into the TRAINING domain (an unseen level or a
missing value → -1, NA) and numerics become float64 with NaN NAs. The
engine builds a transient padded Frame from these columns, so the
device sees the bytes ``Model.predict`` sees on a frame of the same
rows: the ground of the bit-identity of served rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ServingUnsupported(Exception):
    """This model has no serving schema: the engine serves gbm, drf, glm
    and deeplearning models (offset and autoencoder models through their
    ``_score_raw`` on the same transient frame)."""


# (name, training_domain_or_None) per input column, in model order
Schema = List[Tuple[str, Optional[List[str]]]]


def serving_schema(model) -> Schema:
    """The model's input schema: feature names + training categorical
    domains (None = numeric). Tree models carry it in their binning
    spec; GLM/DL in their DataInfo stats."""
    algo = getattr(model, "algo", "")
    if algo in ("gbm", "drf"):
        bm = model.bm
        return [(nm, (bm.domains[j] if bm.is_cat[j] else None))
                for j, nm in enumerate(bm.names)]
    if algo in ("glm", "deeplearning"):
        doms = list(model.di_stats.get("domains") or [])
        return [(nm, (doms[j] if j < len(doms) else None))
                for j, nm in enumerate(model.features)]
    raise ServingUnsupported(
        f"no serving schema for algo '{algo}' "
        f"(fast path supports gbm/drf/glm/deeplearning)")


def parse_rows(schema: Schema, rows: Sequence[dict]) -> Dict[str, np.ndarray]:
    """JSON rows → training-adapted host columns.

    Categorical: int32 codes in the TRAINING domain, -1 = NA (missing,
    null, or a level unseen at training time — the reference maps those
    to NA too). Numeric: float64, NaN = NA. Missing keys are NAs, never
    errors: a scoring client may legitimately omit sparse columns.
    """
    if not isinstance(rows, (list, tuple)) or not rows:
        raise ValueError("'rows' must be a non-empty JSON array of objects")
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            raise ValueError(
                f"row {i} is not a JSON object (got {type(r).__name__})")
    n = len(rows)
    cols: Dict[str, np.ndarray] = {}
    for name, dom in schema:
        if dom is not None:
            lut = {lvl: i for i, lvl in enumerate(dom)}
            out = np.full(n, -1, np.int32)
            for i, r in enumerate(rows):
                v = r.get(name)
                if v is None:
                    continue
                # training domains are interned as strings
                # (water/parser/Categorical.java) — coerce to match
                out[i] = lut.get(v if isinstance(v, str) else str(v), -1)
            cols[name] = out
        else:
            out = np.full(n, np.nan, np.float64)
            for i, r in enumerate(rows):
                v = r.get(name)
                if v is None or v == "":
                    continue
                try:
                    out[i] = float(v)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"row {i}: column '{name}' expects a number, "
                        f"got {v!r}") from None
            cols[name] = out
    return cols


def domains_of(schema: Schema) -> Dict[str, List[str]]:
    """{name: training_domain} for the categorical columns — the
    ``domains=`` argument of ``Frame.from_numpy`` (pre-interned integer
    codes, no re-factorize)."""
    return {name: dom for name, dom in schema if dom is not None}


def concat_columns(parts: Sequence[Dict[str, np.ndarray]]
                   ) -> Dict[str, np.ndarray]:
    """Stack per-request parsed columns into one batch (the micro-batch
    gather before the single padded device dispatch)."""
    if len(parts) == 1:
        return parts[0]
    names = list(parts[0])
    return {nm: np.concatenate([p[nm] for p in parts]) for nm in names}
