"""Native runtime components (C++), loaded through ctypes.

Reference: h2o3_tpu/native/__init__.py. The chunk-parallel CSV tokenizer
(``csv_parser.cpp``, this package's own copy of the reference's source,
the water/parser role) builds at first use with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``build/_csv_parser-<digest>.so`` beside it
(gitignored; the digest covers the source and the flags, so an edited
source rebuilds and a stale library is never loaded). The compiler
writes a temporary file of its own and ``os.replace`` moves it into
place, so processes that build at once (test workers) never see a half
written library and agree on the result. A failed build raises: the
port has no pandas fallback to go to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).with_name("csv_parser.cpp")
BUILD = Path(__file__).with_name("build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + b"\0"
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"_csv_parser-{digest}.so"


def build() -> Path:
    """Compile the tokenizer unless its library exists; returns its path.
    Raises with the compiler's output if ``g++`` fails or is missing."""
    out = lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD, prefix=out.stem + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        try:
            r = subprocess.run(["g++"] + FLAGS + [str(SRC), "-o", tmp],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native csv tokenizer: g++ failed to run: "
                               f"{e}") from e
        if r.returncode != 0:
            raise RuntimeError("native csv tokenizer: g++ failed:\n"
                               + r.stderr[-4000:])
        os.replace(tmp, out)          # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_csv_parser() -> ctypes.CDLL:
    """The loaded tokenizer, built first if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        sig = {
            "csv_parse": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_long,
                                            ctypes.c_char, ctypes.c_int,
                                            ctypes.c_int]),
            "csv_nrows": (ctypes.c_long, [ctypes.c_void_p]),
            "csv_ncols": (ctypes.c_int, [ctypes.c_void_p]),
            "csv_colname": (ctypes.c_char_p, [ctypes.c_void_p,
                                              ctypes.c_int]),
            "csv_coltype": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
            "csv_numeric": (None, [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_double)]),
            "csv_codes": (None, [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]),
            "csv_card": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]),
            "csv_level": (ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]),
            "csv_free": (None, [ctypes.c_void_p]),
        }
        for name, (res, args) in sig.items():
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = args
        _lib = lib
        return lib


def parse_csv_bytes(data: bytes, sep: str = ",", header: bool = True,
                    nthreads: Optional[int] = None, decode: bool = True):
    """Tokenize a CSV buffer natively.

    Returns (columns dict name→ndarray, domains dict name→levels).
    Numeric columns come back float64 with NaN NAs. Categorical columns:
    with decode=True, object arrays of level strings (None for NA); with
    decode=False, raw int32 code arrays (-1 = NA) to feed straight into
    ``Frame.from_numpy(domains=...)`` without re-interning. Raises when
    the tokenizer cannot be built or refuses the buffer.
    """
    lib = load_csv_parser()
    if nthreads is None:
        nthreads = min(os.cpu_count() or 4, 16)
    h = lib.csv_parse(data, len(data), sep.encode()[:1], int(header),
                      int(nthreads))
    if not h:
        raise RuntimeError("native csv tokenizer refused the buffer")
    try:
        n = lib.csv_nrows(h)
        nc = lib.csv_ncols(h)
        cols: Dict[str, np.ndarray] = {}
        domains: Dict[str, list] = {}
        for j in range(nc):
            name = lib.csv_colname(h, j).decode()
            if lib.csv_coltype(h, j) == 0:
                buf = np.empty(n, dtype=np.float64)
                lib.csv_numeric(h, j, buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_double)))
                cols[name] = buf
            else:
                codes = np.empty(n, dtype=np.int32)
                lib.csv_codes(h, j, codes.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int)))
                levels = [lib.csv_level(h, j, k).decode()
                          for k in range(lib.csv_card(h, j))]
                domains[name] = levels
                if decode:
                    vals = np.empty(n, dtype=object)
                    ok = codes >= 0
                    lv = np.asarray(levels, dtype=object)
                    vals[ok] = lv[codes[ok]]
                    vals[~ok] = None
                    cols[name] = vals
                else:
                    cols[name] = codes
        return cols, domains
    finally:
        lib.csv_free(h)
