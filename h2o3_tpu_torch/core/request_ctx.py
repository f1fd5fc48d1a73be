"""Request lifecycle context — deadlines and cooperative cancellation.

Reference: h2o3_tpu/core/request_ctx.py (water/api/RequestServer.java's
bounded pool, water/Job.java's stop_requested() polled at chunk
boundaries). A request deadline rides on a ``contextvars`` variable;
the serving batcher checks it before a dispatch (``cancel_point``) and
on every queued request. Deadlines are ABSOLUTE ``time.monotonic()``
instants (never wall clock: an NTP step must not expire a request).

``job_scope`` installs a ``core/job.Job`` as the thread's current job
(the variable ``current_job`` and ``job_update`` read), with the
deadline the job captured. Not ported: the heartbeat's cloud-health
check in ``cancel_point``, the watchdog's non-retryable list, the
trace context and the deadline counter (ROADMAP A #13).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

from h2o3_tpu_torch.core import job as job_mod


class DeadlineExceeded(Exception):
    """The request's deadline expired; the work was cancelled
    cooperatively (HTTP 408 at a REST boundary)."""


_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "h2o3_torch_request_deadline", default=None)


def current_deadline() -> Optional[float]:
    """The active absolute monotonic deadline, or None."""
    return _DEADLINE.get()


def current_job():
    """The Job whose work is running on this thread, or None."""
    return job_mod.current_job()


def remaining_s() -> Optional[float]:
    """Seconds until the active deadline (negative: expired); None when
    no deadline is set."""
    dl = _DEADLINE.get()
    return None if dl is None else dl - time.monotonic()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[float]) -> Iterator[None]:
    """Install an absolute monotonic deadline for the block (None
    clears an inherited one)."""
    tok = _DEADLINE.set(deadline)
    try:
        yield
    finally:
        _DEADLINE.reset(tok)


@contextlib.contextmanager
def job_scope(job, deadline: Optional[float] = None) -> Iterator[None]:
    """Install ``job`` and its captured deadline as the thread's current
    work unit, so that ``cancel_point`` deep in a loop observes both."""
    tok_j = job_mod._CURRENT.set(job)
    tok_d = _DEADLINE.set(deadline)
    try:
        yield
    finally:
        _DEADLINE.reset(tok_d)
        job_mod._CURRENT.reset(tok_j)


def check_deadline(site: str = "") -> None:
    """Raise DeadlineExceeded if the active deadline has passed."""
    dl = _DEADLINE.get()
    if dl is not None and time.monotonic() >= dl:
        raise DeadlineExceeded(
            f"request deadline exceeded"
            f"{f' at {site}' if site else ''} "
            f"({time.monotonic() - dl:.3f}s past)")


def cancel_point(site: str = "") -> None:
    """Cooperative cancellation checkpoint: raises
    ``JobCancelledException`` after a ``cancel()`` of the current job and
    ``DeadlineExceeded`` past the request deadline."""
    job = job_mod.current_job()
    if job is not None and job.cancel_requested():
        raise job_mod.JobCancelledException(getattr(job, "key", "job"))
    check_deadline(site)
