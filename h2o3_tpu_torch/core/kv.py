"""DKV — the key/value store of the objects a user addresses by key.

Reference: h2o3_tpu/core/kv.py (water/DKV.java, water/Key.java:44). One
process-local store of Frames, Models, Jobs, Grids and uploaded
functions, behind one lock: ``put``, ``get``, ``replace_if`` (a
compare-and-swap), ``remove``, ``keys``, ``clear``. A lazy stub
(``io/lazy.FileBackedFrame``, stored by ``import_file(lazy=True)``) is
restored by the key's first ``get``: the stub parses its file and the
Frame takes the stub's place, unless a newer value was stored under the
key meanwhile, which ``get`` then returns.

Not ported: the durability write-through, the Cleaner's spill of cold
frames (and its eviction back to a stub) and the store's telemetry (the
hooks of the reference's ``put``/``get``/``remove``), which wait for
``core/memgov``, ``core/cleaner`` and ``core/durability`` (ROADMAP A
#13). A value lives on its device until its key is removed.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Iterator, Optional

_counter = itertools.count()


def make_key(prefix: str) -> str:
    """A unique key (Key.make): ``prefix`` and a process-wide number."""
    return f"{prefix}_{next(_counter):04d}"


class _DKV:
    def __init__(self) -> None:
        self._store: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def put(self, key: str, value: Any) -> str:
        with self._lock:
            new = key not in self._store
            self._store[key] = value
        if new:
            # the Scope that is open on this thread owns the new key
            from h2o3_tpu_torch.core.scope import track
            track(key)
        return key

    def get(self, key: str) -> Optional[Any]:
        """The value under ``key``; a lazy stub is restored first (its
        parse runs outside the lock)."""
        with self._lock:
            v = self._store.get(key)
        while getattr(v, "_is_lazy_stub", False):
            try:
                fr = v.restore()
            except Exception:
                # a newer put may have replaced the stub meanwhile: raise
                # only while the store still holds this stub
                with self._lock:
                    cur = self._store.get(key)
                if cur is v:
                    raise
                v = cur
                continue
            with self._lock:
                cur = self._store.get(key)
                if cur is v:
                    self._store[key] = fr
                    cur = fr
            if cur is fr:
                return fr
            v = cur             # a newer value (or stub) won: take it
        return v

    def get_raw(self, key: str) -> Optional[Any]:
        """The value under ``key`` as stored: a lazy stub stays a stub."""
        with self._lock:
            return self._store.get(key)

    def replace_if(self, key: str, expect: Any, value: Any) -> bool:
        """Store ``value`` only if the key still holds ``expect``."""
        with self._lock:
            if self._store.get(key) is not expect:
                return False
            self._store[key] = value
            return True

    def remove(self, key: str) -> None:
        """Drop ``key`` and the keys its value owns (``_owned_keys``: a
        model's fold models and kept cross-validation frames), as the
        reference's cascading remove does."""
        with self._lock:
            value = self._store.pop(key, None)
        for k in getattr(value, "_owned_keys", lambda: ())():
            self.remove(k)

    def keys(self, prefix: str = "") -> Iterator[str]:
        with self._lock:
            return iter([k for k in self._store if k.startswith(prefix)])

    def clear(self) -> None:
        """Drop every key (water/runner/CleanAllKeysTask)."""
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store


DKV = _DKV()
