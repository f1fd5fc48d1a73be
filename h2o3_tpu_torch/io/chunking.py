"""Byte-range chunk planning for the parallel ingest pipeline.

Reference: h2o3_tpu/io/chunking.py (water/fvec/FileVec.java chunking +
the ParseSetup plan that MultiFileParseTask executes — the byte-range
splitter that fans file chunks out to tokenizer workers,
water/parser/ParseDataset.java:253). The same code, less the reference's
``parse_plan`` (the REST /3/ParseSetup report, which waits with the REST
layer); the worker count and window size read their environment
variables and then the reference's defaults (the port has no
``core/config`` ARGS).

Splitting contract: windows are cut at the last newline sitting at even
double-quote parity (RFC4180 — an escaped "" toggles parity twice), so a
quoted field containing the separator or an embedded newline never
straddles a window, and every window starts at a record boundary. gzip
members cannot be range-split, so .gz files fall back to streamed
re-chunking through the same cutter.
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
from typing import IO, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

# 64MB windows: small enough that narrowed per-window blocks transfer
# WHILE workers tokenize the next windows (parse/transfer overlap), big
# enough that per-window tokenizer startup cost is noise.
DEFAULT_CHUNK_BYTES = 64 << 20


def resolve_workers(explicit: Optional[int] = None) -> int:
    """Tokenizer pool size: explicit arg > H2O3TPU_PARSE_WORKERS env > 0.
    0 means one worker per host core; floor 1. workers=1 selects the
    exact sequential path."""
    if explicit is not None:
        v = int(explicit)
    else:
        v = int(os.environ.get("H2O3TPU_PARSE_WORKERS", 0))
    return v if v > 0 else (os.cpu_count() or 1)


def resolve_chunk_bytes(explicit: Optional[int] = None) -> int:
    """Window size in bytes: explicit arg > H2O3TPU_PARSE_CHUNK_MB env
    (MB) > DEFAULT_CHUNK_BYTES."""
    if explicit is not None:
        return max(int(explicit), 1)
    env = os.environ.get("H2O3TPU_PARSE_CHUNK_MB")
    if env is not None:
        return max(int(env), 1) << 20
    return DEFAULT_CHUNK_BYTES


def quote_aware_cut(buf: bytes) -> int:
    """Index one past the LAST newline at even double-quote parity, or 0
    when the window holds no record boundary.

    A newline preceded by an even number of '"' bytes is outside any
    quoted field (windows always start at a record boundary, so parity 0
    at offset 0 is exact; RFC4180 "" escapes toggle twice and cancel).
    """
    a = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(a == 0x0A)          # b"\n"
    if nl.size == 0:
        return 0
    q = np.flatnonzero(a == 0x22)           # b'"'
    if q.size == 0:
        return int(nl[-1]) + 1
    ok = nl[(np.searchsorted(q, nl) & 1) == 0]
    return int(ok[-1]) + 1 if ok.size else 0


def _open(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_line_chunks(paths: Sequence[str],
                     chunk_bytes: int) -> Iterator[Tuple[bytes, bool]]:
    """Yield (window, is_first_window) quote-aware newline-aligned byte
    windows across `paths`.

    Only the very first window carries a header line; repeated header
    lines at the start of files 2..N are stripped HERE so the sequential
    and parallel consumers see byte-identical windows (the reference
    parser likewise skips per-file headers, ParseDataset.java).
    """
    header_line: Optional[bytes] = None
    first = True

    def _emit(window: bytes, first_of_file: bool):
        nonlocal header_line, first
        if first_of_file and not first and header_line and \
                window.startswith(header_line):
            window = window[len(header_line):]
        if not window:
            return None
        if first:
            nl = window.find(b"\n")
            header_line = window[: nl + 1] if nl >= 0 else None
        out = (window, first)
        first = False
        return out

    for path in paths:
        rem = b""
        first_of_file = True
        with _open(path) as f:
            while True:
                buf = f.read(chunk_bytes)
                if not buf:
                    break
                buf = rem + buf
                cut = quote_aware_cut(buf)
                if cut <= 0:
                    rem = buf
                    continue
                rem = buf[cut:]
                out = _emit(buf[:cut], first_of_file)
                first_of_file = False
                if out is not None:
                    yield out
        if rem:
            out = _emit(rem if rem.endswith(b"\n") else rem + b"\n",
                        first_of_file)
            if out is not None:
                yield out


def classify_format(path: str) -> str:
    """Coarse source-format label (telemetry + plan reporting)."""
    p = path.lower()
    if p.endswith(".gz"):
        return "csv.gz"
    ext = os.path.splitext(p)[1]
    return {
        ".parquet": "parquet", ".pq": "parquet",
        ".orc": "orc", ".avro": "avro",
        ".svmlight": "svmlight", ".svm": "svmlight",
        ".arff": "arff", ".xlsx": "xlsx",
    }.get(ext, "csv")


def expand_paths(paths: Union[str, Sequence[str]]) -> List[str]:
    """Glob-expand source patterns (sorted, like the import layer)."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)) or [p])
        elif os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        else:
            out.append(p)
    return out
