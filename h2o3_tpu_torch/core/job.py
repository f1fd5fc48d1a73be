"""Job — trackable work with progress and cancellation.

Reference: h2o3_tpu/core/job.py (water/Job.java:24, start/update/progress
at :206-225). A Job runs its work inline or on a worker thread
(``start(fn, background=True)``), records DONE, FAILED (with the
traceback) or CANCELLED, and is cancelled cooperatively: ``cancel``
sets a flag that the work observes at its next ``update``, which raises
``JobCancelledException``. The training loops reach the running job
through ``job_update`` (a context variable the job installs on the
thread that runs it), at least once a tree (GBM, DRF, XGBoost), an
IRLS or L-BFGS iteration (GLM) and a chunk of steps (DeepLearning);
``update`` reads host state only, so it adds no device sync.

A background job's thread runs on the job's device (the training
frame's): the CUDA device current for raw kernel launches is per
thread, and the thread is pointed at it before the work starts.

Not ported: the infra-error retries, heartbeat, watchdog, request
deadlines, in-fit recovery snapshots, memory-governor finalizers,
telemetry spans and flight recorder (ROADMAP A #13).
"""

from __future__ import annotations

import contextvars
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch

from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.core.scope import Scope

CREATED, RUNNING, DONE, FAILED, CANCELLED = (
    "CREATED", "RUNNING", "DONE", "FAILED", "CANCELLED")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "h2o3_torch_job", default=None)


def free_device_memory(device: Optional[torch.device] = None) -> None:
    """Return the caching allocator's free blocks on ``device`` to the
    driver (the reference drops its jit caches here)."""
    import gc
    gc.collect()
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.empty_cache()


class JobCancelledException(Exception):
    pass


def current_job() -> Optional["Job"]:
    """The job running on this thread, or None."""
    return _CURRENT.get()


def job_update(units: float = 0.0, msg: str = "") -> None:
    """``update`` of the job running on this thread (none: nothing)."""
    job = _CURRENT.get()
    if job is not None:
        job.update(units, msg)


def _thread_device(device: Optional[torch.device]) -> Optional[torch.device]:
    """The CUDA device a worker thread must make current: ``device``
    with the submitting thread's current index when it names none."""
    if device is None or device.type != "cuda":
        return None
    if device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device())


class Job:
    """One unit of trackable work (water/Job.java:24)."""

    def __init__(self, description: str, work: float = 1.0,
                 dest: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.key = make_key("job")
        self.description = description
        self.dest = dest                      # key of the result object
        self.device = device
        self.status = CREATED
        self.exception: Optional[str] = None
        self._work = max(work, 1e-9)
        self._worked = 0.0
        self._msg = ""
        self.start_time = 0.0
        self.end_time = 0.0
        self._cancel_requested = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._result: Any = None
        DKV.put(self.key, self)

    @property
    def result(self) -> Any:
        """What the work returned. A job with a ``dest`` keeps only the
        key: its result is what the DKV holds there, so removing the key
        frees the result while the job stays listed."""
        if self.dest:
            return DKV.get(self.dest)
        return self._result

    def start(self, fn: Callable[["Job"], Any],
              background: bool = False) -> "Job":
        """Run ``fn(job)``; in the background on a thread of its own. A
        foreground failure re-raises after FAILED is recorded."""
        self.status = RUNNING
        self.start_time = time.time()
        cuda_dev = _thread_device(self.device) if background else None

        def _run():
            # keys the work makes belong to a job-local Scope: a
            # cancelled job drops its partial keys, DONE and FAILED
            # jobs keep theirs
            token = _CURRENT.set(self)
            sc = Scope()
            sc.__enter__()
            try:
                if cuda_dev is not None:
                    torch.cuda.set_device(cuda_dev)
                result = fn(self)
                if self.dest and result is not None:
                    DKV.put(self.dest, result)
                elif not self.dest:
                    self._result = result
                self.status = DONE
            except JobCancelledException:
                self.status = CANCELLED
            except Exception as e:  # noqa: BLE001 - the job boundary
                # the traceback before the status: pollers read it on
                # FAILED
                self.exception = "".join(traceback.format_exception(
                    type(e), e, e.__traceback__))
                self.status = FAILED
                if not background:
                    raise
            finally:
                self.end_time = time.time()
                if self.status != CANCELLED:
                    sc.keep(*sc._tracked)
                sc.__exit__(None, None, None)
                if self.status in (CANCELLED, FAILED):
                    # what the stopped work held (its dropped keys, cycles
                    # through its frames) goes back to the device now
                    free_device_memory(self.device)
                _CURRENT.reset(token)

        if background:
            # a new thread starts with an empty context: its job is
            # this one alone
            self._thread = threading.Thread(target=_run, daemon=True,
                                            name=self.key)
            self._thread.start()
        else:
            _run()
        return self

    def update(self, units: float, msg: str = "") -> None:
        """Add ``units`` of work done; raises ``JobCancelledException``
        once ``cancel`` was called."""
        self._worked = min(self._work, self._worked + units)
        if msg:
            self._msg = msg
        if self._cancel_requested.is_set():
            raise JobCancelledException(self.key)

    @property
    def progress(self) -> float:
        if self.status == DONE:
            return 1.0
        return self._worked / self._work

    def cancel(self) -> None:
        self._cancel_requested.set()

    def cancel_requested(self) -> bool:
        return self._cancel_requested.is_set()

    def join(self, timeout: Optional[float] = None) -> "Job":
        if self._thread is not None:
            self._thread.join(timeout)
        return self

    @property
    def run_time(self) -> float:
        end = self.end_time or time.time()
        return end - self.start_time if self.start_time else 0.0

    def to_dict(self) -> dict:
        """The JobV3 wire shape (water/api/schemas3/JobV3.java) that
        h2o-py's H2OJob reads."""
        dest_type = "Key<Keyed>"
        if self.dest:
            from h2o3_tpu_torch.models.model import Model
            if isinstance(DKV.get(self.dest), Model):
                dest_type = "Key<Model>"
        return {
            "__meta": {"schema_version": 3, "schema_name": "JobV3",
                       "schema_type": "Job"},
            "key": {"name": self.key, "type": "Key<Job>",
                    "URL": f"/3/Jobs/{self.key}"},
            "description": self.description,
            "status": self.status,
            "progress": self.progress,
            "progress_msg": self._msg,
            "start_time": int(self.start_time * 1000),
            "msec": int(self.run_time * 1000),
            "dest": {"name": self.dest or "", "type": dest_type},
            "exception": self.exception,
            "stacktrace": self.exception,
            "warnings": [],
            "auto_recoverable": False,
            "ready_for_view": True,
            "run_time_ms": int(self.run_time * 1000),
        }


def list_jobs() -> list:
    out = []
    for k in DKV.keys("job_"):
        j = DKV.get(k)
        if isinstance(j, Job):
            out.append(j.to_dict())
    return out
