"""Model batching — train a grid's shape bucket of combos together.

Reference: h2o3_tpu/parallel/model_batch.py. The grid (``ml/grid.py``)
and the AutoML executor walk their combos one after another, so a grid of
16 GBM combos pays 16 launches of each level kernel where one would do.
This module groups combos into SHAPE BUCKETS (the same structural knobs,
and for GBM the same tree depth bucket) and hands each bucket to its
algorithm's batched trainer: ``models/gbm.fit_gbm_batched`` grows one
tree of every model of the bucket per level launch of the model-axis
kernels (``ops/kernels/treekernel.py``'s ``tree_hist_models``,
``tree_split_models``, ``tree_partition_models``), and
``models/glm.fit_glm_batched`` solves the bucket's (alpha, lambda)
product as batched IRLS. Each model comes out as its sequential fit
would make it.

``BATCHABLE_KNOBS[algo]`` lists the hyper parameters that may vary
WITHIN a bucket; any other knob that varies splits buckets. A bucket its
trainer cannot batch raises ``BatchIneligible`` and the caller walks its
combos sequentially.

Knob: ``H2O3TPU_BATCH_MODELS`` = ``auto`` (the default: batch eligible
buckets of two combos or more) | ``off``/``0``/``false``/``no`` (always
sequential). The reference also reads a ``batch_models`` config entry;
the port has no ``core/config`` yet (ROADMAP A #11), so only the
environment is read. The reference's telemetry (the
``batched_train_batches_total`` / ``batched_train_width`` counters and the
``model_batch.train`` span) waits for ``telemetry/`` (A #13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("h2o3_tpu_torch.model_batch")


class BatchIneligible(Exception):
    """The combo set cannot be trained as one batch; the caller walks its
    combos one after another instead."""


@contextlib.contextmanager
def combo_errors():
    """Inside it, an error of the combos' parameters or of the frame they
    train on (a ValueError, KeyError, TypeError or NotImplementedError,
    as an unknown family or a constant response raise) becomes
    ``BatchIneligible``: the sequential walk then meets it one combo at
    a time and records each failure, as it would without batching. A
    trainer wraps only its checks and its host preamble in it, so that a
    kernel that fails to build or launch (a RuntimeError) still raises."""
    try:
        yield
    except (ValueError, KeyError, TypeError, NotImplementedError) as e:
        raise BatchIneligible(f"a combo fails on its own: {e!r}") from e


# hyper parameters that may vary WITHIN one shape bucket; anything else
# that varies is structural and keys the bucket instead
BATCHABLE_KNOBS: Dict[str, frozenset] = {
    # gbm: max_depth batches within a depth bucket (models/tree.py
    # DEPTH_BUCKETS: every tree is laid out at the bucket's depth, the
    # model's own depth a per-model limit)
    "gbm": frozenset({"learn_rate", "sample_rate",
                      "col_sample_rate_per_tree", "min_rows",
                      "min_split_improvement", "reg_lambda", "seed",
                      "max_depth"}),
    # glm: the (alpha, lambda) product enters the IRLS solve as l1/l2
    "glm": frozenset({"alpha", "lambda_", "Lambda", "lambda"}),
}


def mode() -> str:
    """The ``H2O3TPU_BATCH_MODELS`` value, lower case (``auto`` unset)."""
    v = os.environ.get("H2O3TPU_BATCH_MODELS", "auto")
    return str(v).strip().lower() or "auto"


def enabled() -> bool:
    return mode() not in ("0", "off", "false", "no")


def row_bucket(n: int, max_rows: int) -> int:
    """The padded row count a predict batch of ``n`` rows is planned at:
    powers of two from 8 up to the first power of two >= ``max_rows``."""
    n = max(int(n), 1)
    cap = max(int(max_rows), 1)
    b = 8
    while b < n and b < cap:
        b <<= 1
    return b


def _canon(v):
    """Hashable canonical form of a hyper value (lists become tuples)."""
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    return v


def combo_key(combo: dict) -> tuple:
    """Canonical identity of a combo: its sorted items, lists tupled."""
    return tuple(sorted((k, _canon(v)) for k, v in combo.items()))


def bucket_key(algo: str, combo: dict) -> tuple:
    """Structural signature of a combo: the values of its non-batchable
    knobs, and for gbm the depth bucket of ``max_depth``. Combos with
    equal keys train in one bucket."""
    batchable = BATCHABLE_KNOBS.get(algo, frozenset())
    items: List[Tuple] = []
    for k in sorted(combo):
        if k in batchable:
            if algo == "gbm" and k == "max_depth":
                from h2o3_tpu_torch.models.tree import bucket_depth
                items.append(("max_depth#bucket",
                              bucket_depth(int(combo[k]))))
            continue
        items.append((k, _canon(combo[k])))
    return tuple(items)


@dataclasses.dataclass
class Bucket:
    key: tuple
    indices: List[int]           # positions in the walk-ordered combos

    @property
    def width(self) -> int:
        return len(self.indices)


def plan_buckets(algo: str, combos: Sequence[dict]) -> List[Bucket]:
    """Group walk-ordered combos into shape buckets, in order of first
    occurrence; each bucket's indices ascend."""
    by_key: Dict[tuple, Bucket] = {}
    order: List[Bucket] = []
    for i, c in enumerate(combos):
        k = bucket_key(algo, c)
        b = by_key.get(k)
        if b is None:
            b = Bucket(key=k, indices=[])
            by_key[k] = b
            order.append(b)
        b.indices.append(i)
    return order


def _trainer_for(algo: str):
    """The algorithm's batched trainer, or None."""
    if algo == "gbm":
        from h2o3_tpu_torch.models.gbm import fit_gbm_batched
        return fit_gbm_batched
    if algo == "glm":
        from h2o3_tpu_torch.models.glm import fit_glm_batched
        return fit_glm_batched
    return None


def train_bucket(builder_cls, fixed: dict, combos: Sequence[dict], frame,
                 y: Optional[str] = None, x=None,
                 validation_frame=None) -> List:
    """Train one shape bucket together; returns one Model per combo, in
    combo order, none stored in the DKV. Raises ``BatchIneligible`` where
    the algorithm has no batched trainer or the bucket cannot batch."""
    algo = builder_cls.algo
    trainer = _trainer_for(algo)
    if trainer is None:
        raise BatchIneligible(f"no batched trainer for algo '{algo}'")
    params_list = [{**fixed, **c} for c in combos]
    if any(p.get("checkpoint") is not None for p in params_list):
        raise BatchIneligible("checkpoint restart")
    t0 = time.time()
    models = trainer(builder_cls, params_list, frame, y=y, x=x,
                     validation_frame=validation_frame)
    secs = time.time() - t0
    for m in models:
        m.run_time = secs / len(models)     # the bucket's share a model
    log.info("batched %s bucket: %d models in %.2fs", algo, len(models),
             secs)
    return models
