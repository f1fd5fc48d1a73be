"""Lazy file-backed frames — the water/fvec FileVec role.

Reference: h2o3_tpu/io/lazy.py (water/fvec/FileVec.java:1). A
``FileBackedFrame`` is a DKV stub that holds only its source paths, the
arguments of its parse and header metadata; the key's first ``DKV.get``
parses the files into a Frame (on the device the import named) and
stores it in the stub's place (``core/kv.py``). A stub parses once: a
second ``get`` racing the first waits for the same Frame.

Not ported: the Cleaner's eviction of an unmutated file-backed frame
back to its stub, which waits for ``core/cleaner`` (ROADMAP A #13): a
restored frame stays until its key is removed. ``sniff_meta`` reads CSV
files only; the reference's Parquet footer read needs pyarrow, which the
port does not use.
"""

from __future__ import annotations

import csv as _csv
import os
import threading
from typing import List, Optional


class FileBackedFrame:
    """DKV stub for a frame whose data still lives in its source file."""

    _is_lazy_stub = True

    def __init__(self, key: str, source: str,
                 paths: Optional[List[str]] = None,
                 names: Optional[List[str]] = None,
                 nrows: Optional[int] = None, nbytes: int = 0,
                 parse_kwargs: Optional[dict] = None):
        self.key = key
        self.source = source             # original path/glob, re-expanded
        self.paths = list(paths or [source])   # expanded (metadata only)
        self.names = names or []
        self.nrows = nrows
        self.nbytes = nbytes             # on-disk size (catalog display)
        self.parse_kwargs = parse_kwargs or {}
        self._lock = threading.Lock()
        self._frame = None

    def restore(self):
        """The parsed Frame, keyed ``self.key`` but not stored (the DKV
        swaps it in for the stub). The source string is parsed whole, so
        a glob re-expands as the eager import does."""
        with self._lock:
            if self._frame is None:
                from h2o3_tpu_torch.io.parser import import_file
                fr = import_file(self.source, **self.parse_kwargs)
                fr.key = self.key
                self._frame = fr
            return self._frame


def sniff_meta(path: str, header=None):
    """(names, nrows, nbytes) as cheaply as the format allows: a CSV's
    from its header line and a buffered newline count, (None, None,
    nbytes) for any other file. ``header`` is the caller's choice, so
    the names agree with the frame the parse will build; ``nrows`` is an
    upper bound when quoted fields hold newlines."""
    nbytes = os.path.getsize(path)
    if not path.endswith(".csv"):
        return None, None, nbytes
    from h2o3_tpu_torch.io.parser import guess_header
    with open(path, "rb") as f:
        first_line = f.readline().decode("utf-8", "replace")
        n = 0
        last = b"\n"
        while True:
            blk = f.read(1 << 20)
            if not blk:
                break
            n += blk.count(b"\n")
            last = blk[-1:]
        if last != b"\n":
            n += 1                       # unterminated final row
    names = [c.strip() for c in next(_csv.reader([first_line]), [])]
    has_header = guess_header(path) if header is None else bool(header)
    if not has_header:
        names = [f"C{i + 1}" for i in range(len(names))]
    return names, n + (0 if has_header else 1), nbytes
