"""Runtime configuration (the water.H2O.OptArgs role).

Reference: h2o3_tpu/core/config.py. A flat dataclass whose fields
``Config.from_env(**overrides)`` takes from ``H2O3TPU_<FIELD>`` environment
variables, then from keyword overrides (the ``init()`` kwargs); ``ARGS``
is the process-wide instance the readers consult.

The port keeps the fields it reads: the cloud name, the REST server's
default port and its log level (``api/server.py``), the REST admission
knobs (``AdmissionGate`` and the body cap), ``batch_models``
(``parallel/model_batch.py``) and the serving batcher's knobs
(``serving/batcher.py``). The reference's other
fields belong to layers not ported yet and come with them: the mesh shape,
block rows, heartbeat, retry, scheduler, cluster-telemetry, memory
governor, step profiler, in-fit checkpoint and ingest-worker fields
(ROADMAP A #12 and #13).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    name: str = "h2o3-tpu"           # cloud name (-name)
    port: int = 54321                 # REST port (-port)
    log_level: str = "INFO"           # -log_level
    # -- request hardening (api/server.py admission gate + bounds) -----
    # max requests executing handlers concurrently (the bounded Jetty
    # thread pool role, water/api/RequestServer)
    rest_max_inflight: int = 64
    # requests allowed to WAIT for a slot once saturated; anything past
    # inflight+queue fails fast with 503 + Retry-After
    rest_queue_depth: int = 16
    # longest a queued request waits for a slot before 503
    rest_queue_wait_s: float = 10.0
    # Content-Length cap for buffered bodies (MB); /3/PostFile streams
    # to disk in chunks and is exempt
    rest_max_body_mb: int = 256
    # -- model batching (parallel/model_batch.py) ----------------------
    # "auto" batches eligible grid buckets of >= 2 combos; "off"/"0"
    # walks every combo on its own
    batch_models: str = "auto"
    # -- low-latency scoring tier (serving/batcher.py) -----------------
    # row cap for one coalesced predict dispatch (the largest row bucket)
    score_batch_max_rows: int = 4096
    # how long the per-model dispatcher waits to coalesce requests
    score_batch_wait_ms: float = 2.0
    # bounded per-model predict queue; a full queue answers 503
    score_batch_queue_depth: int = 256

    _INT_FIELDS = frozenset({"port", "rest_max_inflight", "rest_queue_depth",
                             "rest_max_body_mb", "score_batch_max_rows",
                             "score_batch_queue_depth"})
    _FLOAT_FIELDS = frozenset({"rest_queue_wait_s", "score_batch_wait_ms"})

    @staticmethod
    def from_env(**overrides) -> "Config":
        cfg = Config()
        for f in dataclasses.fields(Config):
            env = os.environ.get("H2O3TPU_" + f.name.upper())
            if env is not None:
                if f.name in Config._INT_FIELDS:
                    val = int(env)
                elif f.name in Config._FLOAT_FIELDS:
                    val = float(env)
                else:
                    val = env
                setattr(cfg, f.name, val)
        for k, v in overrides.items():
            if v is not None and hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


# process-wide config (the reference's static H2O.ARGS)
ARGS = Config()
