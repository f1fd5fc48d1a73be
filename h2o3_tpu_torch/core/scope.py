"""Scope — per-call key lifetime tracking (water/Scope.java:22).

Reference: h2o3_tpu/core/scope.py. Every key the DKV stores for the
first time while a Scope is open on this thread is tracked, and removed
when the Scope exits unless it was kept:

    with Scope() as s:
        fr = Frame.from_numpy(..., key="train")   # tracked
        model = est.train(fr, y=...)              # tracked
        s.keep(model.key)                         # survives the scope
    # "train" is gone from the DKV, the model remains
"""

from __future__ import annotations

import threading
from typing import List, Set

from h2o3_tpu_torch.core.kv import DKV

_local = threading.local()


def _stack() -> List["Scope"]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def track(key: str) -> None:
    """Called by ``DKV.put`` for every new key."""
    st = _stack()
    if st:
        st[-1]._tracked.add(key)


class Scope:
    def __init__(self):
        self._tracked: Set[str] = set()
        self._kept: Set[str] = set()

    def keep(self, *keys: str) -> None:
        """Exclude keys from the cleanup (Scope.untrack)."""
        self._kept.update(keys)

    def __enter__(self) -> "Scope":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        for k in self._tracked - self._kept:
            DKV.remove(k)
        # keys kept in a nested scope still belong to the outer scope
        st = _stack()
        if st:
            st[-1]._tracked.update(self._kept)
        return False
