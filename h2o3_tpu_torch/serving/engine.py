"""ScoringEngine — the per-model scorer cache behind the serving tier.

Reference: h2o3_tpu/serving/engine.py. Serving inverts training's ratio:
many small requests instead of one large frame. Per model the engine
keeps a scorer that pads each coalesced batch to a power-of-two ROW
BUCKET (``parallel/model_batch.row_bucket``, 8 up to
``H2O3TPU_SCORE_BATCH_MAX_ROWS``) and warms every bucket when the model
is registered, so no request pays a first-call cost (the caching
allocator's blocks, the library handles).

Bit-identity: a served row has the bits ``Model.predict`` gives it. The
engine runs the model's own halves of scoring, the ones ``_score_raw``
runs: ``_serve_input`` (the training binning or the design matrix),
``_serve_dev`` (the device math; GLM and DeepLearning in fixed row
tiles, ``models/model.score_tiles``, so no product depends on the
bucket) and ``_serve_finish`` (the host tail), then the shared
``_finish_predict`` (the calibrated columns). Offset and autoencoder
models score through ``_score_raw`` on the same transient frame (the
eager fallback).

Each model's dispatcher thread runs on the model's device: the CUDA
device current for a launch is per thread.

Not ported: the memory governor's eviction hook, the telemetry
counters, histograms and spans, the heartbeat's local-work scope and
the fleet registry (ROADMAP A #13); the engine's own counters are in
``stats()``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core import request_ctx
from h2o3_tpu_torch.serving import rows as rows_mod
from h2o3_tpu_torch.serving.batcher import (MicroBatcher, PendingScore,
                                            batch_knobs)


def buckets_for(max_rows: int) -> List[int]:
    """Every row bucket ``row_bucket`` plans for batches up to
    ``max_rows`` rows."""
    from h2o3_tpu_torch.parallel.model_batch import row_bucket
    out, b = [], row_bucket(1, max_rows)
    while True:
        out.append(b)
        nxt = row_bucket(b + 1, max_rows)
        if nxt == b:
            return out
        b = nxt


def model_device(model) -> torch.device:
    """The device a model serves on: its forest's, else the card."""
    from h2o3_tpu_torch.parallel.device import resolve_device
    forest = getattr(model, "forest", None)
    if isinstance(getattr(forest, "feat", None), torch.Tensor):
        return forest.feat.device
    return resolve_device(None)


class Scorer:
    """One model's seat in the cache: its serving schema, its device,
    the buckets it has scored and the warm-ups it took."""

    def __init__(self, model, device: torch.device):
        self.model = model
        self.algo = model.algo
        self.device = device
        self.schema = rows_mod.serving_schema(model)
        oc = model.params.get("offset_column")
        if oc and all(nm != oc for nm, _ in self.schema):
            # the offset rides as a numeric input column
            self.schema.append((oc, None))
        self.domains = rows_mod.domains_of(self.schema)
        self.fallback_reason = self._fallback_reason()
        self.buckets: Dict[int, int] = {}     # padded rows -> dispatches
        self.warmups: Dict[int, int] = {}     # padded rows -> warm-ups
        self.warm = False
        self.warm_lock = threading.Lock()

    def _fallback_reason(self) -> Optional[str]:
        m = self.model
        if not hasattr(m, "_serve_dev") or not hasattr(m, "_serve_finish"):
            return "no device scoring halves"
        if m.params.get("offset_column"):
            return "offset_column"
        if m.algo == "deeplearning" and m.params.get("autoencoder"):
            return "autoencoder"
        return None


class ScoringEngine:
    """Per-model scorers plus continuous micro-batching (the singleton
    ``engine``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._scorers: Dict[str, Scorer] = {}
        self._batchers: Dict[str, MicroBatcher] = {}

    # -- registration --------------------------------------------------
    def register(self, model, device=None) -> Scorer:
        """Idempotent registration: build the scorer (on ``device``, by
        default the model's), warm each row bucket once, and start the
        model's dispatcher. Concurrent callers wait for the one
        warm-up."""
        with self._lock:
            sc = self._scorers.get(model.key)
            if sc is None or sc.model is not model:
                from h2o3_tpu_torch.parallel.device import resolve_device
                dev = (resolve_device(device) if device is not None
                       else model_device(model))
                if dev.type == "cuda" and dev.index is None:
                    # the dispatcher thread is pointed at this index
                    dev = torch.device("cuda", torch.cuda.current_device())
                sc = Scorer(model, dev)      # may raise ServingUnsupported
                self._scorers[model.key] = sc
        with sc.warm_lock:
            if not sc.warm:
                self._warm_up(sc)
                sc.warm = True
        with self._lock:
            if model.key not in self._batchers:
                self._batchers[model.key] = MicroBatcher(
                    model.key,
                    lambda batch, _mk=model.key: self._dispatch(_mk, batch),
                    thread_init=lambda: _use_device(sc.device))
        return sc

    def _warm_up(self, sc: Scorer) -> None:
        """Score all-NA rows at every row bucket through the whole
        pipeline (frame, prep, device half, host tail)."""
        for b in buckets_for(int(batch_knobs()["max_rows"])):
            cols = rows_mod.parse_rows(sc.schema, [{}] * b)
            self._score_window(sc, cols, b)
            sc.warmups[b] = sc.warmups.get(b, 0) + 1

    # -- public scoring ------------------------------------------------
    def score_rows(self, model, rows: List[dict],
                   deadline: Optional[float] = None,
                   wait_timeout_s: float = 300.0, device=None
                   ) -> Tuple[Dict[str, np.ndarray], Dict, Dict]:
        """The row-payload entry: parse → enqueue → coalesced device
        dispatch → this request's slice. Returns ``(columns, domains,
        meta)``. Raises ``QueueSaturated`` on a full queue and
        ``DeadlineExceeded`` when the request deadline (``deadline`` or
        the ambient ``request_ctx`` one) expires in the queue or in
        flight."""
        sc = self.register(model, device)
        cols = rows_mod.parse_rows(sc.schema, rows)
        if deadline is None:
            deadline = request_ctx.current_deadline()
        pending = PendingScore(cols, len(rows), deadline=deadline)
        with self._lock:
            batcher = self._batchers[model.key]
        batcher.submit(pending)
        timeout = wait_timeout_s
        if deadline is not None:
            timeout = max(deadline - time.monotonic(), 0.0) + 0.25
        if not pending.wait(timeout):
            raise request_ctx.DeadlineExceeded(
                f"predict for {model.key} did not complete within "
                f"{timeout:.1f}s")
        if pending.error is not None:
            raise pending.error
        out, domains = pending.result
        return out, domains, dict(pending.meta)

    def score_columns(self, model, cols: Dict[str, np.ndarray], n: int,
                      device=None) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Scoring of pre-parsed columns on the caller's thread, past the
        batcher."""
        sc = self.register(model, device)
        with torch.cuda.device(sc.device) if sc.device.type == "cuda" \
                else contextlib.nullcontext():
            return self._score_cols(sc, cols, n)

    # -- dispatch ------------------------------------------------------
    def _dispatch(self, model_key: str, batch: List[PendingScore]) -> None:
        with self._lock:
            sc = self._scorers.get(model_key)
        if sc is None or not sc.warm:
            for p in batch:
                p.finish(error=KeyError(
                    f"serving scorer for {model_key} was evicted"))
            return
        cols = rows_mod.concat_columns([p.cols for p in batch])
        n = sum(p.n for p in batch)
        out, domains = self._score_cols(sc, cols, n)
        off = 0
        for p in batch:
            sl = {nm: arr[off:off + p.n] for nm, arr in out.items()}
            p.finish(result=(sl, domains), batch_requests=len(batch),
                     batch_rows=n)
            off += p.n

    def _score_cols(self, sc: Scorer, cols: Dict[str, np.ndarray],
                    n: int) -> Tuple[Dict, Dict]:
        """Score training-adapted host columns: window to the bucket cap,
        score each window at its bucket, reassemble, then the shared
        ``_finish_predict`` tail."""
        max_rows = int(batch_knobs()["max_rows"])
        parts = []
        for lo in range(0, n, max_rows):
            hi = min(lo + max_rows, n)
            win = cols if (lo == 0 and hi == n) else \
                {nm: a[lo:hi] for nm, a in cols.items()}
            parts.append(self._score_window(sc, win, hi - lo))
            b = _bucket(hi - lo, max_rows)
            sc.buckets[b] = sc.buckets.get(b, 0) + 1
        merged = parts[0] if len(parts) == 1 else {
            nm: np.concatenate([p[nm] for p in parts]) for nm in parts[0]}
        model = sc.model
        return model._finish_predict(merged), model.predict_domains()

    def _score_window(self, sc: Scorer, cols: Dict[str, np.ndarray],
                      n: int) -> Dict[str, np.ndarray]:
        from h2o3_tpu_torch.frame.frame import Frame
        from h2o3_tpu_torch.parallel.device import fetch
        model = sc.model
        fr = Frame.from_numpy(cols, domains=sc.domains, device=sc.device,
                              pad_to=_bucket(n, int(batch_knobs()[
                                  "max_rows"])))
        if sc.fallback_reason is not None:
            return model._score_raw(fr)
        x = model._serve_input(fr)
        return model._serve_finish(fetch(model._serve_dev(x)), n)

    # -- lifecycle -----------------------------------------------------
    def evict(self, exclude: Optional[set] = None) -> int:
        """Drop scorers (all but ``exclude``); returns how many. The
        batchers stay up: the next request re-registers and re-warms its
        model."""
        with self._lock:
            keys = [k for k in self._scorers
                    if not (exclude and k in exclude)]
            for k in keys:
                del self._scorers[k]
        return len(keys)

    def queue_depth(self, model_key: Optional[str] = None) -> int:
        """Pending predict requests of one model, or of every batcher."""
        with self._lock:
            if model_key is not None:
                b = self._batchers.get(model_key)
                return b.depth() if b is not None else 0
            return sum(b.depth() for b in self._batchers.values())

    def warm_models(self) -> List[str]:
        """Model keys with a warm scorer."""
        with self._lock:
            return sorted(k for k, sc in self._scorers.items() if sc.warm)

    def stats(self) -> Dict:
        """Per model: algo, device, the eager fallback's reason, the
        buckets scored (dispatches a bucket), the warm-ups a bucket,
        the batcher's dispatches and rows."""
        with self._lock:
            out = {}
            for k, sc in self._scorers.items():
                b = self._batchers.get(k)
                out[k] = {"algo": sc.algo, "device": str(sc.device),
                          "fallback_reason": sc.fallback_reason,
                          "buckets": dict(sorted(sc.buckets.items())),
                          "warmups": dict(sorted(sc.warmups.items())),
                          "dispatches": b.dispatches if b else 0,
                          "rows": b.rows_dispatched if b else 0}
            return {"models": out}

    def drain(self) -> None:
        """Graceful shutdown: close every batcher (the dispatcher joins,
        its in-flight batch finishes, queued requests fail with
        ``BatcherDraining``) and drop the scorers."""
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
            self._scorers.clear()
        for b in batchers:
            b.close()

    reset = drain


def _bucket(n: int, max_rows: int) -> int:
    from h2o3_tpu_torch.parallel.model_batch import row_bucket
    return row_bucket(n, max_rows)


def _use_device(device: torch.device) -> None:
    """Point the calling thread at ``device`` (a CUDA one)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


# the process-wide engine (the scorer cache is per process, like the DKV)
engine = ScoringEngine()
