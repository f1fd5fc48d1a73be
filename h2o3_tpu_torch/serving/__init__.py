"""The serving tier: row payloads scored through micro-batches.

Reference: h2o3_tpu/serving/__init__.py. ``rows`` and ``batcher`` are
device-free; the engine (``get_engine``) scores on the model's device.
``serving/fleet.py`` (replicas behind a router) is ROADMAP A #13.
"""

from h2o3_tpu_torch.serving.batcher import (BatcherDraining, MicroBatcher,
                                            PendingScore, QueueSaturated,
                                            batch_knobs)
from h2o3_tpu_torch.serving.rows import (Schema, ServingUnsupported,
                                         concat_columns, domains_of,
                                         parse_rows, serving_schema)

__all__ = [
    "BatcherDraining", "MicroBatcher", "PendingScore", "QueueSaturated",
    "batch_knobs", "Schema", "ServingUnsupported", "concat_columns",
    "domains_of", "parse_rows", "serving_schema", "get_engine",
]


def get_engine():
    """The process-wide :class:`~h2o3_tpu_torch.serving.engine.ScoringEngine`."""
    from h2o3_tpu_torch.serving.engine import engine
    return engine
