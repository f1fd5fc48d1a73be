"""Continuous micro-batching for the serving tier.

Reference: h2o3_tpu/serving/batcher.py. Concurrent predict calls
enqueue parsed row payloads into a bounded per-model queue; ONE
dispatcher thread per model coalesces whatever is waiting (up to
``H2O3TPU_SCORE_BATCH_WAIT_MS``, capped at
``H2O3TPU_SCORE_BATCH_MAX_ROWS`` rows) into a single padded device
dispatch and scatters per-request slices back.

- A full queue (``H2O3TPU_SCORE_BATCH_QUEUE_DEPTH``) raises
  :class:`QueueSaturated` at once (a REST tier answers 503 +
  Retry-After); the caller never blocks on it.
- A request deadline (``core/request_ctx``) rides on each
  :class:`PendingScore`: an expired entry fails with
  ``DeadlineExceeded`` before it costs a device dispatch.
- The dispatcher calls ``cancel_point`` between dispatches.

The module is device-free (stdlib and the engine's ``dispatch_fn``).
Not ported: the heartbeat's local-work scope around a dispatch, the
trace context a request carries and the logger (ROADMAP A #13). The
knobs come from the environment over ``core/config.ARGS``, as the
reference reads them.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from h2o3_tpu_torch.core import config as _config
from h2o3_tpu_torch.core import request_ctx


class QueueSaturated(RuntimeError):
    """The per-model predict queue is full (503 + Retry-After at a REST
    tier)."""


class BatcherDraining(RuntimeError):
    """The batcher is shutting down: new submissions and entries still
    queued at ``close()`` fail with this class rather than hang."""


def batch_knobs() -> Dict[str, float]:
    """The micro-batch knobs, read at each call: the environment
    (``H2O3TPU_SCORE_BATCH_{MAX_ROWS,WAIT_MS,QUEUE_DEPTH}``) over
    ``core/config.ARGS``."""
    env = os.environ.get
    a = _config.ARGS
    return {
        "max_rows": max(1, int(env("H2O3TPU_SCORE_BATCH_MAX_ROWS",
                                   a.score_batch_max_rows))),
        "wait_ms": max(0.0, float(env("H2O3TPU_SCORE_BATCH_WAIT_MS",
                                      a.score_batch_wait_ms))),
        "queue_depth": max(1, int(env("H2O3TPU_SCORE_BATCH_QUEUE_DEPTH",
                                      a.score_batch_queue_depth))),
    }


class PendingScore:
    """One request's seat in the micro-batch: parsed columns in, a
    per-request result slice (or error) out."""

    __slots__ = ("cols", "n", "deadline", "enqueue_t", "result", "error",
                 "meta", "_event")

    def __init__(self, cols: Dict, n: int,
                 deadline: Optional[float] = None):
        self.cols = cols
        self.n = int(n)
        self.deadline = deadline          # absolute time.monotonic()
        self.enqueue_t = time.monotonic()
        self.result = None
        self.error: Optional[BaseException] = None
        self.meta: Dict = {}
        self._event = threading.Event()

    def finish(self, result=None, error: Optional[BaseException] = None,
               **meta) -> None:
        self.result = result
        self.error = error
        self.meta.update(meta)
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class MicroBatcher:
    """Bounded queue + coalescing dispatcher for ONE model.

    ``dispatch_fn(batch)`` receives the coalesced ``PendingScore`` list
    and must ``finish()`` every entry; if it raises instead, every
    unfinished entry fails with that error. ``thread_init`` runs first
    on the dispatcher thread (the engine points it at the model's CUDA
    device: the device current for a launch is per thread).
    """

    def __init__(self, name: str,
                 dispatch_fn: Callable[[List[PendingScore]], None],
                 max_rows: Optional[int] = None,
                 wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 cancel_site: str = "serving.dispatch",
                 thread_init: Optional[Callable[[], None]] = None):
        knobs = batch_knobs()
        self.name = name
        self.dispatch_fn = dispatch_fn
        self.max_rows = int(max_rows if max_rows is not None
                            else knobs["max_rows"])
        self.wait_ms = float(wait_ms if wait_ms is not None
                             else knobs["wait_ms"])
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else knobs["queue_depth"])
        self.cancel_site = cancel_site
        self.thread_init = thread_init
        self.dispatches = 0
        self.rows_dispatched = 0
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=f"score-batch:{name}", daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------
    def submit(self, pending: PendingScore) -> None:
        """Enqueue one request; raises :class:`QueueSaturated` when the
        bounded queue is full."""
        with self._cond:
            if self._closed:
                raise BatcherDraining(
                    f"batcher {self.name} is draining; retry later")
            if len(self._q) >= self.queue_depth:
                raise QueueSaturated(
                    f"predict queue for {self.name} is full "
                    f"({self.queue_depth} waiting); retry later")
            self._q.append(pending)
            self._cond.notify()

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    # -- dispatcher side -----------------------------------------------
    def _collect(self) -> List[PendingScore]:
        """Block for the first request, then coalesce whatever arrives
        within ``wait_ms`` up to ``max_rows`` rows. An oversized single
        request rides alone (the engine windows it)."""
        with self._cond:
            while not self._q and not self._closed:
                self._cond.wait(0.25)
            if not self._q:
                return []
            batch = [self._q.popleft()]
        rows = batch[0].n
        limit = time.monotonic() + self.wait_ms / 1000.0
        while rows < self.max_rows:
            with self._cond:
                while self._q and rows + self._q[0].n <= self.max_rows:
                    p = self._q.popleft()
                    batch.append(p)
                    rows += p.n
                left = limit - time.monotonic()
                if left <= 0 or self._closed or rows >= self.max_rows:
                    break
                self._cond.wait(left)
        return batch

    def _loop(self) -> None:
        if self.thread_init is not None:
            self.thread_init()
        while True:
            batch = self._collect()
            if not batch:
                if self._closed:
                    return
                continue
            try:
                request_ctx.cancel_point(self.cancel_site)
            except BaseException as e:   # noqa: BLE001 - fan the failure out
                for p in batch:
                    p.finish(error=e)
                continue
            now = time.monotonic()
            live = []
            for p in batch:
                if p.deadline is not None and now >= p.deadline:
                    p.finish(error=request_ctx.DeadlineExceeded(
                        f"request deadline expired in the predict queue "
                        f"({now - p.deadline:.3f}s past)"))
                else:
                    live.append(p)
            if not live:
                continue
            self.dispatches += 1
            self.rows_dispatched += sum(p.n for p in live)
            try:
                self.dispatch_fn(live)
            except BaseException as e:   # noqa: BLE001 - request boundary
                for p in live:
                    if not p.done:
                        p.finish(error=e)

    def close(self, join: bool = True) -> None:
        """Graceful drain: stop accepting, let the dispatcher finish its
        in-flight batch (``join``), then fail anything still queued with
        :class:`BatcherDraining`."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if join:
            self._thread.join(timeout=2.0)
        with self._cond:
            drained = list(self._q)
            self._q.clear()
        for p in drained:
            p.finish(error=BatcherDraining(
                f"batcher {self.name} closed while request was queued; "
                f"retry later"))
